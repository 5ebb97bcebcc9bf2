"""Protocol ports between pipeline phases (reference src/core/interfaces.py:23-66).

Mirrors ``office_person_detection_vit_tpu/core/interfaces.py``, over the
port's own records (``core/dto.py``). Unlike the reference (where adapters
were never wired), the phases here accept any implementation of these
Protocols, so tests can swap fakes without mocks.
"""

from __future__ import annotations

from datetime import datetime
from typing import Any, Iterator, Protocol, runtime_checkable

import numpy as np

from .dto import Detection, DetectionBatch


@runtime_checkable
class FrameSourcePort(Protocol):
    def frames(self) -> Iterator[tuple[int, np.ndarray]]:
        """Yield (frame_number, HxWx3 uint8 BGR frame)."""
        ...


@runtime_checkable
class DetectorPort(Protocol):
    def load_model(self) -> None: ...

    def detect(self, frame: np.ndarray) -> list[Detection]: ...

    def detect_batch(self, frames: np.ndarray) -> DetectionBatch:
        """Batched path: (F, H, W, 3) uint8 -> DetectionBatch."""
        ...


@runtime_checkable
class TrackerPort(Protocol):
    def update(self, detections: list[Detection], **kw: Any) -> list[Any]: ...

    def reset(self) -> None: ...


@runtime_checkable
class TransformerPort(Protocol):
    def transform_pixel(self, x: float, y: float) -> tuple[float, float]: ...

    def transform_batch(self, points: np.ndarray) -> np.ndarray:
        """(N, 2) camera px -> (N, 2) floormap px."""
        ...


@runtime_checkable
class AggregatorPort(Protocol):
    def aggregate_frame(self, timestamp: str, zone_ids_per_detection: list[list[str]]) -> None: ...

    def get_zone_counts(self) -> dict[str, dict[str, int]]: ...


@runtime_checkable
class VisualizerPort(Protocol):
    def plot_time_series(self, *a: Any, **kw: Any) -> Any: ...


@runtime_checkable
class OCRPort(Protocol):
    def extract(self, frame: np.ndarray, frame_number: int) -> tuple[datetime | None, float]: ...
