"""Multi-object tracking (Phase 2.5): the cascade (host), the hybrid tracker
with optical flow (host) and the scan tracker (on the device)."""

from ..ops.assignment import HungarianAlgorithm
from .lightweight_tracker import LightweightTracker, OpticalFlowTracker
from .reid_feature_extractor import ReIDFeatureExtractor
from .similarity import SimilarityCalculator
from .track import Track, TrackState
from .tracker import Tracker

__all__ = [
    "HungarianAlgorithm",
    "LightweightTracker",
    "OpticalFlowTracker",
    "ReIDFeatureExtractor",
    "SimilarityCalculator",
    "Track",
    "TrackState",
    "Tracker",
]
