"""Pipeline phases 2-5 of the port: detection, transform, aggregation and
visualization. Tracking waits for a later slice (ROADMAP A.5)."""

from .aggregation import AggregationPhase
from .base import BasePhase
from .detection import DetectionPhase
from .transform import TransformPhase
from .visualization import VisualizationPhase

__all__ = ["AggregationPhase", "BasePhase", "DetectionPhase", "TransformPhase", "VisualizationPhase"]
