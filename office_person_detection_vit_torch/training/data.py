"""Training input pipeline: a decoded-frame cache and a background batch
prefetch.

Mirrors ``office_person_detection_vit_tpu/training/data.py``:

- each image is decoded and resized to the working resolution once and kept
  as a uint8 host array in a cache bounded by bytes (least recently used
  first out);
- one producer thread (the port's ``video/prefetch.py::prefetch_iter``)
  assembles the next batches while the card runs the current step;
- the order of epoch e is ``default_rng((seed, e))``, so a resumed run sees
  the order the uninterrupted run would have, and the batches equal the JAX
  loader's.

Ragged tails are dropped (fixed shapes, as the trainer's step).
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from ..video.prefetch import prefetch_iter

logger = logging.getLogger(__name__)


def pack_targets_np(per_image_boxes: Sequence, per_image_labels: Sequence,
                    capacity: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ragged targets -> fixed-shape (labels int32 (B, T), boxes float32
    (B, T, 4), valid bool (B, T)); boxes past ``capacity`` are dropped."""
    B = len(per_image_boxes)
    labels = np.zeros((B, capacity), np.int32)
    boxes = np.zeros((B, capacity, 4), np.float32)
    valid = np.zeros((B, capacity), bool)
    for i, (bx, lb) in enumerate(zip(per_image_boxes, per_image_labels)):
        n = min(len(bx), capacity)
        if n:
            boxes[i, :n] = np.asarray(bx, np.float32)[:n]
            labels[i, :n] = np.asarray(lb, np.int32)[:n]
            valid[i, :n] = True
    return labels, boxes, valid


class FrameCache:
    """uint8 frame cache keyed by path, bounded by total bytes."""

    def __init__(self, resize_wh: tuple[int, int] = (1280, 720), limit_bytes: int = 4 << 30):
        self.resize_wh = resize_wh
        self.limit_bytes = int(limit_bytes)
        self._store: OrderedDict[str, np.ndarray] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, path: Path) -> np.ndarray:
        key = str(path)
        frame = self._store.get(key)
        if frame is not None:
            self.hits += 1
            self._store.move_to_end(key)
            return frame
        self.misses += 1
        import cv2

        img = cv2.imread(key)
        if img is None:
            # Not cached: a failed decode is retried next epoch, so a blank
            # never becomes permanent training signal against real boxes.
            logger.warning("unreadable image %s; substituting blank", path)
            w, h = self.resize_wh
            return np.zeros((h, w, 3), np.uint8)
        if (img.shape[1], img.shape[0]) != self.resize_wh:
            img = cv2.resize(img, self.resize_wh)
        self._store[key] = img
        self._bytes += img.nbytes
        while self._bytes > self.limit_bytes and len(self._store) > 1:
            _, old = self._store.popitem(last=False)
            self._bytes -= old.nbytes
        return img


class COCOBatchLoader:
    """Epoch iterator of host batches for the train step.

    ``samples`` is ``load_coco_dataset``'s list of ``(path,
    boxes_cxcywh_norm, labels)``. Each batch is a dict of numpy arrays:
    ``frames_u8`` (B, H, W, 3) and fixed-shape ``labels`` / ``boxes`` /
    ``valid``; the consumer uploads and preprocesses them.
    """

    def __init__(self, samples: Sequence, batch_size: int, *, capacity: int = 25,
                 resize_wh: tuple[int, int] = (1280, 720), seed: int = 0, depth: int = 2,
                 cache_limit_bytes: int = 4 << 30):
        self.samples = list(samples)
        self.batch_size = int(batch_size)
        self.capacity = int(capacity)
        self.seed = int(seed)
        self.depth = int(depth)
        self.cache = FrameCache(resize_wh, cache_limit_bytes)

    @property
    def steps_per_epoch(self) -> int:
        return len(self.samples) // self.batch_size

    def _build(self, idx: np.ndarray) -> dict:
        chosen = [self.samples[j] for j in idx]
        frames = np.stack([self.cache.get(s[0]) for s in chosen])
        labels, boxes, valid = pack_targets_np([s[1] for s in chosen], [s[2] for s in chosen],
                                               self.capacity)
        return {"frames_u8": frames, "labels": labels, "boxes": boxes, "valid": valid}

    def epoch(self, epoch_idx: int) -> Iterator[dict]:
        """Prefetching iterator over epoch ``epoch_idx``'s shuffled batches
        (a producer exception re-raises here; leaving early stops the
        producer)."""
        order = np.random.default_rng((self.seed, epoch_idx)).permutation(len(self.samples))

        def batches() -> Iterator[dict]:
            for i in range(self.steps_per_epoch):
                yield self._build(order[i * self.batch_size:(i + 1) * self.batch_size])

        yield from prefetch_iter(batches(), depth=self.depth)
