"""Pipeline phases 2-5 of the port: detection, tracking (2.5), transform,
aggregation and visualization."""

from .aggregation import AggregationPhase
from .base import BasePhase
from .detection import DetectionPhase
from .tracking import TrackingPhase
from .transform import TransformPhase
from .visualization import VisualizationPhase

__all__ = ["AggregationPhase", "BasePhase", "DetectionPhase", "TrackingPhase", "TransformPhase",
           "VisualizationPhase"]
