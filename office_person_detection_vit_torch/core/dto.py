"""Host-side detection records.

Mirrors ``office_person_detection_vit_tpu/core/dto.py`` for what the slice
needs: ``Detection``, ``FrameResult``, ``DetectionBatch`` and
``detections_to_batch``. The JAX copy registers ``DetectionBatch`` as a pytree
of device arrays; here it is a plain dataclass whose fields are host numpy
arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Any

import numpy as np


@dataclass
class Detection:
    """One detected person in camera pixels: bbox (x, y, w, h) from the
    top-left corner; foot_point is the bbox's bottom-center."""

    bbox: tuple[float, float, float, float]
    confidence: float
    center: tuple[float, float] | None = None
    foot_point: tuple[float, float] | None = None

    def __post_init__(self) -> None:
        x, y, w, h = self.bbox
        if self.center is None:
            self.center = (x + w / 2.0, y + h / 2.0)
        if self.foot_point is None:
            self.foot_point = (x + w / 2.0, y + h)


@dataclass
class FrameResult:
    """All per-frame pipeline state for one sampled frame."""

    frame_number: int
    timestamp: datetime | str | None
    detections: list[Detection] = field(default_factory=list)


@dataclass
class DetectionBatch:
    """Fixed-capacity detections of F frames, Q slots each, as numpy arrays.

    boxes_xywh (F, Q, 4) float32 pixels; scores (F, Q) float32; valid (F, Q)
    bool; foot (F, Q, 2) float32 bottom-center points.
    """

    boxes_xywh: np.ndarray
    scores: np.ndarray
    valid: np.ndarray
    foot: np.ndarray

    @property
    def num_frames(self) -> int:
        return self.boxes_xywh.shape[0]

    @property
    def capacity(self) -> int:
        return self.boxes_xywh.shape[1]

    def to_frame_results(
        self,
        frame_numbers: list[int] | None = None,
        timestamps: list[Any] | None = None,
    ) -> list[FrameResult]:
        """Strip the invalid slots into per-frame ``Detection`` lists."""
        results: list[FrameResult] = []
        for f in range(self.num_frames):
            dets = [
                Detection(
                    bbox=tuple(float(v) for v in self.boxes_xywh[f, q]),
                    confidence=float(self.scores[f, q]),
                    foot_point=(float(self.foot[f, q, 0]), float(self.foot[f, q, 1])),
                )
                for q in range(self.capacity)
                if self.valid[f, q]
            ]
            results.append(
                FrameResult(
                    frame_number=frame_numbers[f] if frame_numbers else f,
                    timestamp=timestamps[f] if timestamps else None,
                    detections=dets,
                )
            )
        return results


def detections_to_batch(frames: list[list[Detection]], capacity: int = 100) -> DetectionBatch:
    """Pack ragged per-frame detections into a fixed-shape batch."""
    F = len(frames)
    boxes = np.zeros((F, capacity, 4), np.float32)
    scores = np.zeros((F, capacity), np.float32)
    valid = np.zeros((F, capacity), bool)
    foot = np.zeros((F, capacity, 2), np.float32)
    for f, dets in enumerate(frames):
        for q, det in enumerate(dets[:capacity]):
            boxes[f, q] = det.bbox
            scores[f, q] = det.confidence
            valid[f, q] = True
            foot[f, q] = det.foot_point
    return DetectionBatch(boxes_xywh=boxes, scores=scores, valid=valid, foot=foot)
