"""Temporal validation of OCR'd timestamps
(reference src/timestamp/timestamp_validator_v2.py:42-188).

Frame-rate-consistency check with adaptive tolerance (base + 1.5 sigma of the
recent interval history, clamped to [0.5x, 3x] base) and z-score outlier
detection with linear-interpolation recovery.

The port's own copy of ``office_person_detection_vit_tpu/timestamp/timestamp_validator.py`` (host code, unchanged).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from datetime import datetime, timedelta

import numpy as np


@dataclass
class ValidationResult:
    is_valid: bool
    timestamp: datetime | None
    confidence: float
    reason: str = ""
    corrected: bool = False


class NoOpValidator:
    """Validation disabled (reference frame_extraction_pipeline.py:349-360)."""

    def validate(self, timestamp: datetime, frame_number: int, confidence: float = 1.0) -> ValidationResult:
        return ValidationResult(True, timestamp, confidence)

    def reset(self) -> None:  # pragma: no cover
        pass


class TemporalValidatorV2:
    def __init__(
        self,
        fps: float = 30.0,
        time_compression_ratio: float = 1.0,
        base_tolerance_seconds: float = 30.0,
        history_size: int = 10,
        z_score_threshold: float = 3.0,
    ):
        self.fps = float(fps)
        self.ratio = float(time_compression_ratio)
        self.base_tolerance = float(base_tolerance_seconds)
        self.z_threshold = float(z_score_threshold)
        self.history: deque[tuple[int, datetime]] = deque(maxlen=history_size)
        self.interval_history: deque[float] = deque(maxlen=history_size)

    @classmethod
    def from_config(cls, cfg) -> "TemporalValidatorV2":
        return cls(
            fps=float(cfg.get("video.fps", 30.0)),
            time_compression_ratio=float(cfg.get("video.time_compression_ratio", 1.0)),
            base_tolerance_seconds=float(
                cfg.get("timestamp.extraction.validator.base_tolerance_seconds", 30.0)
            ),
            history_size=int(cfg.get("timestamp.extraction.validator.history_size", 10)),
            z_score_threshold=float(
                cfg.get("timestamp.extraction.validator.z_score_threshold", 3.0)
            ),
        )

    # ------------------------------------------------------------------ API
    def validate(
        self, timestamp: datetime, frame_number: int, confidence: float = 1.0
    ) -> ValidationResult:
        if not self.history:
            self._accept(frame_number, timestamp)
            return ValidationResult(True, timestamp, confidence)

        prev_frame, prev_ts = self.history[-1]
        frame_diff = frame_number - prev_frame
        if frame_diff <= 0:
            return ValidationResult(False, None, 0.0, reason="non-monotonic frame")
        expected_dt = frame_diff / self.fps * self.ratio  # wall-clock seconds
        actual_dt = (timestamp - prev_ts).total_seconds()

        tolerance = self._adaptive_tolerance()
        if abs(actual_dt - expected_dt) <= tolerance:
            self._accept(frame_number, timestamp)
            return ValidationResult(True, timestamp, confidence)

        # Outlier: z-score against interval history -> interpolate recovery
        # (reference :137-181).
        z = self._z_score(actual_dt, expected_dt)
        if z > self.z_threshold or actual_dt < 0:
            corrected = prev_ts + timedelta(seconds=expected_dt)
            self._accept(frame_number, corrected)
            return ValidationResult(
                True, corrected, confidence * 0.5,
                reason=f"outlier z={z:.1f}, interpolated", corrected=True,
            )
        return ValidationResult(
            False, None, 0.0,
            reason=f"dt {actual_dt:.1f}s vs expected {expected_dt:.1f}s (tol {tolerance:.1f}s)",
        )

    def reset(self) -> None:
        self.history.clear()
        self.interval_history.clear()

    # ------------------------------------------------------------ internals
    def _accept(self, frame_number: int, timestamp: datetime) -> None:
        if self.history:
            prev_frame, prev_ts = self.history[-1]
            d_frames = frame_number - prev_frame
            if d_frames > 0:
                per_frame = (timestamp - prev_ts).total_seconds() / d_frames
                self.interval_history.append(per_frame)
        self.history.append((frame_number, timestamp))

    def _adaptive_tolerance(self) -> float:
        """base + 1.5 sigma, clamped to [0.5x, 3x] base (reference :110-135)."""
        if len(self.interval_history) < 3:
            return self.base_tolerance
        sigma = float(np.std(self.interval_history)) * self.fps  # scale to seconds-ish
        tol = self.base_tolerance + 1.5 * sigma
        return float(np.clip(tol, 0.5 * self.base_tolerance, 3.0 * self.base_tolerance))

    def _z_score(self, actual_dt: float, expected_dt: float) -> float:
        if len(self.interval_history) < 3:
            return abs(actual_dt - expected_dt) / max(self.base_tolerance, 1e-9)
        arr = np.asarray(self.interval_history) * self.fps
        sigma = max(float(arr.std()), 1e-6)
        return abs(actual_dt - expected_dt) / sigma
