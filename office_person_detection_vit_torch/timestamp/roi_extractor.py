"""Timestamp ROI extraction + preprocessing (reference src/timestamp/roi_extractor.py:29-95).

Ratio-based crop (default: right-top region) then OCR-friendly preprocessing:
upscale to >= 300 px wide (cubic), grayscale, light Gaussian blur, CLAHE —
deliberately *no* binarization (reference finding, :61-95).

The port's own copy of ``office_person_detection_vit_tpu/timestamp/roi_extractor.py`` (host code, unchanged).
"""

from __future__ import annotations

import numpy as np


class TimestampROIExtractor:
    def __init__(
        self,
        x_ratio: float = 0.70,
        y_ratio: float = 0.045,
        width_ratio: float = 0.28,
        height_ratio: float = 0.06,
        min_width: int = 300,
    ):
        self.x_ratio = x_ratio
        self.y_ratio = y_ratio
        self.width_ratio = width_ratio
        self.height_ratio = height_ratio
        self.min_width = min_width

    @classmethod
    def from_config(cls, cfg) -> "TimestampROIExtractor":
        g = lambda k, d: cfg.get(f"timestamp.extraction.roi.{k}", d)
        return cls(
            x_ratio=float(g("x_ratio", 0.70)),
            y_ratio=float(g("y_ratio", 0.045)),
            width_ratio=float(g("width_ratio", 0.28)),
            height_ratio=float(g("height_ratio", 0.06)),
        )

    def extract_roi(self, frame: np.ndarray) -> np.ndarray:
        h, w = frame.shape[:2]
        x0 = int(w * self.x_ratio)
        y0 = int(h * self.y_ratio)
        x1 = min(w, x0 + int(w * self.width_ratio))
        y1 = min(h, y0 + int(h * self.height_ratio))
        return frame[y0:y1, x0:x1]

    def preprocess_roi(self, roi: np.ndarray) -> np.ndarray:
        import cv2

        if roi.size == 0:
            return roi
        h, w = roi.shape[:2]
        if w < self.min_width and w > 0:
            scale = self.min_width / w
            roi = cv2.resize(
                roi, (self.min_width, max(1, int(h * scale))), interpolation=cv2.INTER_CUBIC
            )
        if roi.ndim == 3:
            roi = cv2.cvtColor(roi, cv2.COLOR_BGR2GRAY)
        roi = cv2.GaussianBlur(roi, (3, 3), 0)
        clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
        return clahe.apply(roi)
