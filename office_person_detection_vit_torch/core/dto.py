"""Host-side detection records.

Mirrors ``office_person_detection_vit_tpu/core/dto.py``: ``Detection`` (with
its JSON forms ``to_dict`` and ``to_compact_dict``, whose keys and rounding
are the JAX package's), ``FrameResult``, ``AggregationResult``,
``DetectionBatch`` and ``detections_to_batch``. The JAX copy registers
``DetectionBatch`` as a pytree of device arrays; here it is a plain dataclass
whose fields are host numpy arrays.
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
    track_id: int | None = None
    floor_coords_px: tuple[float, float] | None = None
    floor_coords_mm: tuple[float, float] | None = None
    zone_ids: list[str] = field(default_factory=list)
    feature: np.ndarray | None = None
    class_id: int = 1  # COCO "person"

    def __post_init__(self) -> None:
        x, y, w, h = self.bbox
        if self.center is None:
            self.center = (x + w / 2.0, y + h / 2.0)
        if self.foot_point is None:
            self.foot_point = (x + w / 2.0, y + h)

    def to_dict(self, *, precision: int | None = None) -> dict[str, Any]:
        """The full-key JSON form of ``detections.json`` and
        ``coordinate_transformations.json``; ``precision`` rounds coordinates."""

        def _r(v: float) -> float:
            return round(float(v), precision) if precision is not None else float(v)

        d: dict[str, Any] = {
            "bbox": {"x": _r(self.bbox[0]), "y": _r(self.bbox[1]),
                     "width": _r(self.bbox[2]), "height": _r(self.bbox[3])},
            "confidence": float(self.confidence),
            "camera_coords": {"x": _r(self.foot_point[0]), "y": _r(self.foot_point[1])},
        }
        if self.floor_coords_px is not None:
            d["floor_coords_px"] = {"x": _r(self.floor_coords_px[0]), "y": _r(self.floor_coords_px[1])}
        if self.floor_coords_mm is not None:
            d["floor_coords_mm"] = {"x": _r(self.floor_coords_mm[0]), "y": _r(self.floor_coords_mm[1])}
        if self.zone_ids:
            d["zone_ids"] = list(self.zone_ids)
        if self.track_id is not None:
            d["track_id"] = int(self.track_id)
        return d

    def to_compact_dict(self, *, precision: int = 1, exclude_px: bool = True) -> dict[str, Any]:
        """The compact-key JSON form (``output.json_optimization.compact_keys``)."""

        def _r(v: float) -> float:
            return round(float(v), precision)

        d: dict[str, Any] = {
            "bb": [_r(v) for v in self.bbox],
            "conf": round(float(self.confidence), 3),
            "cam": [_r(self.foot_point[0]), _r(self.foot_point[1])],
        }
        if self.floor_coords_px is not None and not exclude_px:
            d["floor_px"] = [_r(self.floor_coords_px[0]), _r(self.floor_coords_px[1])]
        if self.floor_coords_mm is not None:
            d["floor_mm"] = [_r(self.floor_coords_mm[0]), _r(self.floor_coords_mm[1])]
        if self.zone_ids:
            d["zones"] = list(self.zone_ids)
        if self.track_id is not None:
            d["id"] = int(self.track_id)
        return d


@dataclass
class FrameResult:
    """All per-frame pipeline state for one sampled frame."""

    frame_number: int
    timestamp: datetime | str | None
    detections: list[Detection] = field(default_factory=list)
    frame_path: str | None = None
    zone_counts: dict[str, int] = field(default_factory=dict)

    @property
    def timestamp_str(self) -> str:
        if self.timestamp is None:
            return ""
        if isinstance(self.timestamp, datetime):
            return self.timestamp.strftime("%Y-%m-%d %H:%M:%S")
        return str(self.timestamp)

    @property
    def timestamp_stem(self) -> str:
        """Filename-safe stem of every per-frame artifact:
        ``YYYYMMDD_HHMMSS``, or the zero-padded frame number when the frame
        has no timestamp."""
        ts = self.timestamp_str.replace(":", "").replace("-", "").replace(" ", "_")
        return ts if ts else f"{self.frame_number:06d}"


@dataclass
class AggregationResult:
    """Per-timestamp zone occupancy counts."""

    timestamp: str
    zone_counts: dict[str, int]
    total_count: int = 0

    def __post_init__(self) -> None:
        if not self.total_count:
            self.total_count = int(sum(self.zone_counts.values()))


@dataclass
class EvaluationMetrics:
    precision: float
    recall: float
    f1_score: float
    true_positives: int
    false_positives: int
    false_negatives: int

    def to_dict(self) -> dict[str, Any]:
        return {
            "precision": self.precision,
            "recall": self.recall,
            "f1_score": self.f1_score,
            "true_positives": self.true_positives,
            "false_positives": self.false_positives,
            "false_negatives": self.false_negatives,
        }


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
