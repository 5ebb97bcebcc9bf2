"""Re-ID appearance features: the detector's encoder features, or crop
histograms.

Mirrors ``office_person_detection_vit_tpu/tracking/reid_feature_extractor.py``:
``model_type: detr`` with a detector takes the features of the detector's
own detections (``detect_with_features``), matched to the requested boxes by
IoU, with a crop histogram for a box that matches none; every other case
ends at crop histograms. ``model_type: clip`` with a model source set raises:
a torch CLIP image tower needs weights that the repo does not hold (ROADMAP
A.3b); without a source it warns and takes the histograms, as in JAX.
"""

from __future__ import annotations

import logging

import numpy as np

from ..detection.features import crop_histogram_features
from .similarity import SimilarityCalculator

logger = logging.getLogger(__name__)


class ReIDFeatureExtractor:
    def __init__(self, model_type: str = "detr", model_name: str | None = None, model_path: str | None = None,
                 detector=None):
        self.model_type = model_type
        self.model_name = model_name
        self.model_path = model_path
        self.detector = detector
        self.backend = "histogram"
        self.feature_dim = 256

    @classmethod
    def from_config(cls, cfg, detector=None) -> "ReIDFeatureExtractor":
        return cls(
            model_type=str(cfg.get("tracking.reid.model_type", "detr")),
            model_name=cfg.get("tracking.reid.model_name", None),
            model_path=cfg.get("tracking.reid.model_path", None),
            detector=detector,
        )

    def cleanup(self) -> None:
        self.detector = None

    def load_model(self) -> None:
        """Take the first backend of the chain that is available."""
        if self.model_type == "detr" and self.detector is not None:
            self.backend = "detr"
            self.feature_dim = self.detector.detr_config.d_model
            logger.info("ReID backend: DETR encoder ROI features (%d-d)", self.feature_dim)
            return
        if self.model_type == "clip":
            source = self.model_path or self.model_name
            if source:
                raise NotImplementedError(
                    f"tracking.reid.model_type=clip with {source!r}: the CLIP image tower is not ported "
                    "(ROADMAP A.3b)")
            logger.warning("CLIP unavailable (%s); falling back to histogram",
                           ValueError("tracking.reid.model_path/model_name not set"))
        self.backend = "histogram"
        self.feature_dim = 256
        logger.info("ReID backend: crop histograms (256-d)")

    def extract_features(self, frame: np.ndarray, bboxes: list[tuple[float, float, float, float]]) -> np.ndarray:
        """N boxes -> (N, feature_dim) L2-normalised features."""
        if not bboxes:
            return np.zeros((0, self.feature_dim), np.float32)
        if self.backend == "detr" and self.detector is not None:
            dets, _ = self.detector.detect_with_features(frame)
            if dets:
                iou = SimilarityCalculator.iou_matrix(np.asarray(bboxes, np.float32),
                                                      np.asarray([d.bbox for d in dets], np.float32))
                out = np.zeros((len(bboxes), self.feature_dim), np.float32)
                for i, j in enumerate(iou.argmax(axis=1)):
                    if iou[i, j] > 0.5 and dets[j].feature is not None:
                        out[i] = dets[j].feature
                    else:
                        out[i] = crop_histogram_features(frame, np.asarray([bboxes[i]], np.float32),
                                                         dim=self.feature_dim)[0]
                return out
        return crop_histogram_features(frame, np.asarray(bboxes, np.float32), dim=self.feature_dim)
