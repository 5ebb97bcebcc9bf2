"""A track of the cascade: a Kalman-filtered centre, an EMA appearance
feature and the observation-centric re-update.

Mirrors ``office_person_detection_vit_tpu/tracking/track.py``: the numpy
constant-velocity filter of ``ops.kalman``; a feature history of 10 and an
EMA feature (alpha 0.9, L2-normalised again); after 3 or more missed frames,
linearly interpolated virtual observations are replayed through the filter
when the track is found again.
"""

from __future__ import annotations

from collections import deque
from enum import Enum

import numpy as np

from ..core.dto import Detection
from ..ops import kalman


class TrackState(Enum):
    TENTATIVE = "tentative"
    CONFIRMED = "confirmed"
    DELETED = "deleted"


ORU_MIN_GAP = 3
FEATURE_EMA_ALPHA = 0.9
FEATURE_HISTORY = 10


class Track:
    def __init__(self, track_id: int, detection: Detection, timestamp: float = 0.0, min_hits: int = 1):
        self.track_id = track_id
        self.bbox = tuple(detection.bbox)
        self.confidence = float(detection.confidence)
        self.min_hits = min_hits
        cx, cy = detection.center
        self.kf = kalman.kf_init_np(np.asarray([cx, cy], np.float32))
        self.hits = 1
        self.age = 1
        self.time_since_update = 0
        self.state = TrackState.CONFIRMED if self.hits >= min_hits else TrackState.TENTATIVE
        self.features: deque[np.ndarray] = deque(maxlen=FEATURE_HISTORY)
        self.smoothed_feature: np.ndarray | None = None
        if detection.feature is not None:
            self._push_feature(detection.feature)
        self.trajectory: list[tuple[float, tuple[float, float, float, float]]] = [(timestamp, self.bbox)]
        self.last_update_time = float(timestamp)
        self.last_predict_time = float(timestamp)
        self._last_observed_center = (cx, cy)

    def _push_feature(self, feature: np.ndarray) -> None:
        f = np.asarray(feature, np.float32)
        n = np.linalg.norm(f)
        if n > 1e-12:
            f = f / n
        self.features.append(f)
        if self.smoothed_feature is None:
            self.smoothed_feature = f
        else:
            s = FEATURE_EMA_ALPHA * self.smoothed_feature + (1 - FEATURE_EMA_ALPHA) * f
            n = np.linalg.norm(s)
            self.smoothed_feature = s / n if n > 1e-12 else s

    def get_smoothed_feature(self) -> np.ndarray | None:
        return self.smoothed_feature

    def predict(self, timestamp: float | None = None) -> None:
        dt = 1.0
        if timestamp is not None:
            dt = max(float(timestamp) - self.last_predict_time, 1e-3)
            self.last_predict_time = float(timestamp)
        self.kf = kalman.kf_predict_np(self.kf, dt)
        self.age += 1
        self.time_since_update += 1

    @property
    def predicted_center(self) -> tuple[float, float]:
        pos = np.asarray(kalman.kf_position(self.kf))
        return float(pos[0]), float(pos[1])

    def update(self, detection: Detection, timestamp: float | None = None) -> None:
        ts = float(timestamp) if timestamp is not None else self.last_update_time + self.time_since_update
        cx, cy = detection.center
        if self.time_since_update >= ORU_MIN_GAP:
            self._apply_oru((cx, cy), ts)
        self.kf = kalman.kf_update_np(self.kf, np.asarray([cx, cy], np.float32))
        self.bbox = tuple(detection.bbox)
        self.confidence = float(detection.confidence)
        if detection.feature is not None:
            self._push_feature(detection.feature)
        self.hits += 1
        self.time_since_update = 0
        self.trajectory.append((ts, self.bbox))
        self.last_update_time = ts
        self.last_predict_time = ts
        self._last_observed_center = (cx, cy)
        if self.state == TrackState.TENTATIVE and self.hits >= self.min_hits:
            self.state = TrackState.CONFIRMED

    def _apply_oru(self, new_center: tuple[float, float], ts: float) -> None:
        """Replay linearly interpolated virtual observations over the gap:
        the filter starts again at the last real observation and walks the
        virtual trajectory in unit steps."""
        gap = self.time_since_update
        x0, y0 = self._last_observed_center
        x1, y1 = new_center
        self.kf = kalman.kf_init_np(np.asarray([x0, y0], np.float32))
        for i in range(1, gap):
            f = i / gap
            vx = x0 + (x1 - x0) * f
            vy = y0 + (y1 - y0) * f
            self.kf = kalman.kf_predict_np(self.kf, 1.0)
            self.kf = kalman.kf_update_np(self.kf, np.asarray([vx, vy], np.float32))
        self.kf = kalman.kf_predict_np(self.kf, 1.0)

    def mark_missed(self, max_age: int) -> None:
        if self.state == TrackState.TENTATIVE:
            self.state = TrackState.DELETED
        elif self.time_since_update > max_age:
            self.state = TrackState.DELETED

    @property
    def is_confirmed(self) -> bool:
        return self.state == TrackState.CONFIRMED

    @property
    def is_deleted(self) -> bool:
        return self.state == TrackState.DELETED

    def to_dict(self) -> dict:
        x, y, w, h = self.bbox
        return {
            "track_id": self.track_id,
            "bbox": {"x": x, "y": y, "width": w, "height": h},
            "confidence": self.confidence,
            "hits": self.hits,
            "age": self.age,
            "state": self.state.value,
        }
