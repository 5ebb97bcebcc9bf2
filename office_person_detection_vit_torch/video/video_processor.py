"""Video decode/seek (reference src/video/video_processor.py:45-232).

Host-side OpenCV; the device never sees video bytes: decoded uint8 frame
batches go up to the detector's preprocessing in one copy.

The port's own copy of ``office_person_detection_vit_tpu/video/video_processor.py`` (host code; only this docstring differs).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

EXPECTED_WIDTH = 1280
EXPECTED_HEIGHT = 720
EXPECTED_FPS = 30.0


class VideoProcessor:
    def __init__(self, video_path: str | Path):
        self.video_path = Path(video_path)
        self.cap = None
        self.frame_count = 0
        self.fps = 0.0
        self.width = 0
        self.height = 0

    def open(self) -> bool:
        import cv2

        if not self.video_path.exists():
            raise FileNotFoundError(f"video not found: {self.video_path}")
        self.cap = cv2.VideoCapture(str(self.video_path))
        if not self.cap.isOpened():
            raise IOError(f"failed to open video: {self.video_path}")
        self.frame_count = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS))
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self._validate()
        return True

    def _validate(self) -> None:
        """Warn-only spec check (reference :91-119)."""
        if (self.width, self.height) != (EXPECTED_WIDTH, EXPECTED_HEIGHT):
            logger.warning(
                "video is %dx%d (expected %dx%d)",
                self.width, self.height, EXPECTED_WIDTH, EXPECTED_HEIGHT,
            )
        if abs(self.fps - EXPECTED_FPS) > 1.0:
            logger.warning("video fps %.2f (expected %.1f)", self.fps, EXPECTED_FPS)

    def get_frame(self, frame_number: int) -> np.ndarray | None:
        """Random access by CAP_PROP_POS_FRAMES seek (reference :121-159)."""
        import cv2

        if self.cap is None:
            self.open()
        if frame_number < 0 or frame_number >= self.frame_count:
            return None
        self.cap.set(cv2.CAP_PROP_POS_FRAMES, frame_number)
        ok, frame = self.cap.read()
        return frame if ok else None

    def get_frames(self, frame_numbers: list[int]) -> list[np.ndarray | None]:
        """Batch random access, sorted to minimize seeking."""
        order = np.argsort(frame_numbers)
        out: list[np.ndarray | None] = [None] * len(frame_numbers)
        for i in order:
            out[int(i)] = self.get_frame(int(frame_numbers[int(i)]))
        return out

    def read_next_frame(self) -> np.ndarray | None:
        if self.cap is None:
            self.open()
        ok, frame = self.cap.read()
        return frame if ok else None

    def iter_frames(self, frame_numbers):
        """Sequential strided decode: yields (frame_number, frame) for a
        SORTED ascending frame list using grab() to skip — ~10x faster than
        per-frame CAP_PROP_POS_FRAMES seeks for coarse-scan strides."""
        if self.cap is None:
            self.open()
        import cv2

        self.cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
        pos = 0
        for fn in frame_numbers:
            if fn < pos:
                raise ValueError("iter_frames requires ascending frame numbers")
            while pos < fn:
                if not self.cap.grab():
                    return
                pos += 1
            ok, frame = self.cap.read()
            pos += 1
            if not ok:
                return
            yield fn, frame

    @property
    def duration_seconds(self) -> float:
        return self.frame_count / self.fps if self.fps else 0.0

    def release(self) -> None:
        if self.cap is not None:
            self.cap.release()
            self.cap = None

    def __enter__(self) -> "VideoProcessor":
        self.open()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
