"""Re-ID appearance features: the detector's encoder features, a CLIP image
tower, or crop histograms.

Mirrors ``office_person_detection_vit_tpu/tracking/reid_feature_extractor.py``:
``model_type: detr`` with a detector takes the features of the detector's
own detections (``detect_with_features``), matched to the requested boxes by
IoU, with a crop histogram for a box that matches none. ``model_type: clip``
loads the CLIP image tower (``models/clip.py``) of the local checkpoint
directory ``model_path`` or ``model_name`` (``models/weights.py::
load_clip_tower``) on ``device`` (``detection.device``: the card unless the
config asks for the CPU; no card raises) and embeds each box's crop:
resized to the tower's input on the host as JAX does, uploaded once a call,
normalised, through the tower (float32, TF32 off; its attention runs the
CUDA kernels on the card) and L2-normalised there. Without a source, or
with a checkpoint that is missing or cannot be read, it warns and takes the
crop histograms, as in JAX; an error of the forward pass is raised.
"""

from __future__ import annotations

import logging

import cv2
import numpy as np
import torch

from ..detection.features import crop_histogram_features
from ..device import config_device, full_float32, resolve_device
from ..models.clip import CLIP_MEAN, CLIP_STD
from ..models.weights import load_clip_tower
from .similarity import SimilarityCalculator

logger = logging.getLogger(__name__)


class ReIDFeatureExtractor:
    def __init__(self, model_type: str = "detr", model_name: str | None = None, model_path: str | None = None,
                 detector=None, device: torch.device | str = "auto"):
        self.model_type = model_type
        self.model_name = model_name
        self.model_path = model_path
        self.detector = detector
        self.device = device
        self._clip = None
        self.backend = "histogram"
        self.feature_dim = 256

    @classmethod
    def from_config(cls, cfg, detector=None) -> "ReIDFeatureExtractor":
        return cls(
            model_type=str(cfg.get("tracking.reid.model_type", "detr")),
            model_name=cfg.get("tracking.reid.model_name", None),
            model_path=cfg.get("tracking.reid.model_path", None),
            detector=detector,
            device=config_device(cfg),
        )

    def cleanup(self) -> None:
        self.detector = None
        self._clip = None

    def load_model(self) -> None:
        """Take the first backend of the chain that is available."""
        if self.model_type == "detr" and self.detector is not None:
            self.backend = "detr"
            self.feature_dim = self.detector.detr_config.d_model
            logger.info("ReID backend: DETR encoder ROI features (%d-d)", self.feature_dim)
            return
        if self.model_type == "clip":
            source = self.model_path or self.model_name
            if not source:
                logger.warning("CLIP unavailable (%s); falling back to histogram",
                               ValueError("tracking.reid.model_path/model_name not set"))
            else:
                device = resolve_device(str(self.device))
                try:
                    # A local directory only: the deployment has no network.
                    self._clip = load_clip_tower(source, device)
                except (OSError, ValueError, KeyError) as e:  # missing or unreadable checkpoint
                    logger.warning("CLIP unavailable (%s); falling back to histogram", e)
                else:
                    self.device = device
                    self.backend = "clip"
                    self.feature_dim = self._clip.config.projection_dim
                    logger.info("ReID backend: CLIP image tower (%d-d) on %s", self.feature_dim, device)
                    return
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
        if self.backend == "clip":
            return self._extract_clip(frame, bboxes)
        return crop_histogram_features(frame, np.asarray(bboxes, np.float32), dim=self.feature_dim)

    @torch.inference_mode()
    def _extract_clip(self, frame: np.ndarray, bboxes) -> np.ndarray:
        """Crop (clamped to the frame; an empty crop is 8x8 black) -> resized
        to the tower's input (``cv2.resize``, bilinear) -> RGB on the host,
        as the JAX extractor does; then one upload, CLIP's normalisation, the
        tower and the L2 norm on the device."""
        size = self._clip.config.image_size
        H, W = frame.shape[:2]
        crops = []
        for x, y, w, h in bboxes:
            x0, y0 = max(int(x), 0), max(int(y), 0)
            x1, y1 = min(int(x + w), W), min(int(y + h), H)
            crop = frame[y0:y1, x0:x1]
            if crop.size == 0:
                crop = np.zeros((8, 8, 3), np.uint8)
            crops.append(cv2.resize(crop, (size, size))[..., ::-1])  # BGR -> RGB
        pixels = torch.from_numpy(np.ascontiguousarray(np.stack(crops))).to(self.device)
        mean, std = (torch.tensor(v, dtype=torch.float32, device=self.device) for v in (CLIP_MEAN, CLIP_STD))
        pixels = ((pixels.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
        with full_float32():
            feats = self._clip(pixels)
        return (feats / feats.norm(dim=1, keepdim=True).clamp_min(1e-12)).cpu().numpy()
