"""Detection statistics of a run, in host numpy.

Mirrors ``office_person_detection_vit_tpu/utils/stats_utils.py``: masked
reductions over the fixed-shape ``DetectionBatch`` (F frames x Q slots)
instead of a per-frame loop. The keys of the result are those of
``detection_statistics.json``.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..core.dto import DetectionBatch, FrameResult, detections_to_batch

_EMPTY = {
    "total_frames": 0,
    "total_detections": 0,
    "avg_detections_per_frame": 0.0,
    "max_detections_per_frame": 0,
    "min_detections_per_frame": 0,
    "confidence": {"mean": 0.0, "std": 0.0, "min": 0.0, "max": 0.0},
}


def _batch_stats(scores: np.ndarray, valid: np.ndarray) -> dict[str, Any]:
    validf = valid.astype(np.float32)
    per_frame = validf.sum(axis=1)  # (F,)
    total = per_frame.sum()
    conf_sum = float((scores * validf).sum())
    safe_total = max(total, 1.0)
    mean_conf = conf_sum / safe_total
    var = float((validf * (scores - mean_conf) ** 2).sum()) / safe_total
    return {
        "total": total,
        "per_frame_mean": per_frame.mean(),
        "per_frame_max": per_frame.max(),
        "per_frame_min": per_frame.min(),
        "conf_mean": mean_conf,
        "conf_std": float(np.sqrt(var)),
        "conf_min": float(np.where(valid, scores, np.inf).min()),
        "conf_max": float(np.where(valid, scores, -np.inf).max()),
    }


def calculate_detection_statistics(batch: DetectionBatch) -> dict[str, Any]:
    """(F, Q) -> the dict of ``detection_statistics.json``."""
    if batch.num_frames == 0:
        return {**_EMPTY, "confidence": dict(_EMPTY["confidence"])}
    stats = _batch_stats(np.asarray(batch.scores), np.asarray(batch.valid))
    total = int(stats["total"])
    return {
        "total_frames": int(batch.num_frames),
        "total_detections": total,
        "avg_detections_per_frame": float(stats["per_frame_mean"]),
        "max_detections_per_frame": int(stats["per_frame_max"]),
        "min_detections_per_frame": int(stats["per_frame_min"]),
        "confidence": {
            "mean": float(stats["conf_mean"]) if total else 0.0,
            "std": float(stats["conf_std"]) if total else 0.0,
            "min": float(stats["conf_min"]) if total else 0.0,
            "max": float(stats["conf_max"]) if total else 0.0,
        },
    }


def calculate_frame_statistics(frames: list[FrameResult]) -> dict[str, Any]:
    """The same statistics from per-frame host lists."""
    if not frames:
        return {**_EMPTY, "confidence": dict(_EMPTY["confidence"])}
    cap = max(1, max(len(f.detections) for f in frames))
    return calculate_detection_statistics(detections_to_batch([f.detections for f in frames], capacity=cap))
