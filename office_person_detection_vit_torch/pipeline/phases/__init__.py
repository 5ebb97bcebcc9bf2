"""Pipeline phases 2-4 of the port: detection, transform and aggregation.
Tracking and visualization wait for a later slice (ROADMAP)."""

from .aggregation import AggregationPhase
from .base import BasePhase
from .detection import DetectionPhase
from .transform import TransformPhase

__all__ = ["AggregationPhase", "BasePhase", "DetectionPhase", "TransformPhase"]
