"""Host->device prefetch pipeline.

An async producer queue that keeps the detector fed while host threads do
video seek/decode and OCR. The reference has no such component (per-frame
synchronous decode+transfer, SURVEY.md §3.1).

Two layers:

- :func:`prefetch_iter` — the generic harness: consume any iterable on a
  background thread through a bounded queue, re-raising producer
  exceptions at the consumer. Deadlock-free at any depth — the producer's
  puts poll a stop event, so abandoning the iterator mid-stream can never
  leave the thread blocked. Shared by the video loader below and the
  training batch loader (training/data.py).
- :class:`PrefetchLoader` — decodes frame batches into the queue
  (double/triple buffering); the consumer pops ready uint8 batches and
  hands them on, overlapping host I/O with the consumer's work.

The port's own copy of ``office_person_detection_vit_tpu/video/prefetch.py`` (host code; only this docstring differs).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_SENTINEL = object()


def prefetch_iter(iterable: Iterable, depth: int = 2,
                  join_timeout: float = 5.0) -> Iterator:
    """Yield ``iterable``'s items, produced on a background thread through
    a ``depth``-bounded queue.

    A producer exception is re-raised at the consumer when reached. Early
    consumer exit (break / generator close) stops the producer promptly:
    every producer put polls the stop event, so no queue size can strand
    the thread on a blocking ``put``.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err: list[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for item in iterable:
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised by consumer
            err.append(e)
        finally:
            _put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        if err:
            raise err[0]
    finally:
        stop.set()
        deadline = time.monotonic() + join_timeout
        while thread.is_alive() and time.monotonic() < deadline:
            try:  # free slots so a pending put can observe the stop event
                q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=0.05)


class PrefetchLoader:
    def __init__(
        self,
        frame_numbers: Sequence[int],
        fetch_fn: Callable[[int], np.ndarray | None] | None = None,
        batch_size: int = 4,
        depth: int = 3,
        iter_fn: Callable[[Sequence[int]], "Iterator[tuple[int, np.ndarray]]"] | None = None,
    ):
        """Either ``fetch_fn(frame_number) -> frame`` (random access) or
        ``iter_fn(frame_numbers) -> iter of (frame_number, frame)``
        (sequential strided decode, e.g. VideoProcessor.iter_frames — much
        faster for ascending scans)."""
        if (fetch_fn is None) == (iter_fn is None):
            raise ValueError("provide exactly one of fetch_fn / iter_fn")
        self.frame_numbers = list(frame_numbers)
        self.fetch_fn = fetch_fn
        self.iter_fn = iter_fn
        self.batch_size = int(batch_size)
        self.depth = int(depth)
        self._stop = threading.Event()

    # ------------------------------------------------------------- producer
    def _pairs(self):
        if self.iter_fn is not None:
            yield from self.iter_fn(self.frame_numbers)
            return
        for fn in self.frame_numbers:
            frame = self.fetch_fn(fn)
            if frame is None:
                logger.warning("frame %d failed to decode; skipping", fn)
                continue
            yield fn, frame

    def _batches(self) -> Iterator[tuple[list[int], np.ndarray]]:
        batch_frames: list[np.ndarray] = []
        batch_numbers: list[int] = []
        for fn, frame in self._pairs():
            if self._stop.is_set():
                return
            batch_frames.append(frame)
            batch_numbers.append(fn)
            if len(batch_frames) == self.batch_size:
                yield batch_numbers, np.stack(batch_frames)
                batch_frames, batch_numbers = [], []
        if batch_frames:
            yield batch_numbers, np.stack(batch_frames)

    # ------------------------------------------------------------- consumer
    def __iter__(self) -> Iterator[tuple[list[int], np.ndarray]]:
        self._stop.clear()
        yield from prefetch_iter(self._batches(), depth=self.depth)

    def close(self) -> None:
        self._stop.set()
