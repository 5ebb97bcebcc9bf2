"""Visualization of the port: charts, floormaps, the dashboard's session
loader and the Re-ID feature diagnostics."""

from .dashboard_utils import SessionDataLoader
from .feature_visualizer import FeatureVisualizer
from .floormap_visualizer import FloormapVisualizer
from .visualizer import Visualizer

__all__ = ["FeatureVisualizer", "FloormapVisualizer", "SessionDataLoader", "Visualizer"]
