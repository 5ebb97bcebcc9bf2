"""Frame sampling strategies (reference src/video/frame_sampler.py:44-181).

The port's own copy of ``office_person_detection_vit_tpu/video/frame_sampler.py`` (host code, unchanged).
"""

from __future__ import annotations

from typing import Iterator


class CoarseSampler:
    """Fixed-stride frame iterator (reference :44-64)."""

    def __init__(self, interval_seconds: float, fps: float):
        self.stride = max(1, int(round(interval_seconds * fps)))

    def sample(self, frame_count: int, start: int = 0, end: int | None = None) -> Iterator[int]:
        end = frame_count if end is None else min(end, frame_count)
        yield from range(start, end, self.stride)


class FineSampler:
    """+/- window around an approximate frame at fine stride (reference :109-138)."""

    def __init__(self, interval_seconds: float, window_seconds: float, fps: float):
        self.stride = max(1, int(round(interval_seconds * fps)))
        self.window = int(round(window_seconds * fps))

    def sample_around_target(self, approx_frame: int, frame_count: int) -> list[int]:
        start = max(0, approx_frame - self.window)
        end = min(frame_count, approx_frame + self.window + 1)
        return list(range(start, end, self.stride))


class AdaptiveSampler:
    """Confidence-driven interval adjustment (reference :141-181)."""

    def __init__(
        self,
        base_interval_seconds: float,
        fps: float,
        min_interval: float = 0.5,
        max_interval: float = 30.0,
    ):
        self.fps = fps
        self.interval = float(base_interval_seconds)
        self.min_interval = min_interval
        self.max_interval = max_interval

    def adjust_interval(self, confidence: float) -> float:
        """High confidence -> widen stride; low -> tighten."""
        if confidence > 0.8:
            self.interval = min(self.interval * 1.5, self.max_interval)
        elif confidence < 0.4:
            self.interval = max(self.interval * 0.5, self.min_interval)
        return self.interval

    @property
    def stride(self) -> int:
        return max(1, int(round(self.interval * self.fps)))
