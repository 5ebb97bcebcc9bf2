"""Resource cleanup (reference src/utils/memory_utils.py:12-42).

The port's own copy of ``office_person_detection_vit_tpu/utils/memory_utils.py``:
run each object's ``cleanup``, collect garbage, and hand the CUDA caching
allocator's free blocks back to the card (``torch.cuda.empty_cache``, where
the JAX package clears its jit caches). Needed only between phases that swap
large models.
"""

from __future__ import annotations

import gc
import logging

import torch

logger = logging.getLogger(__name__)


def cleanup_resources(*objects: object) -> None:
    """Drop references, run the GC, and empty the CUDA allocator's cache."""
    for obj in objects:
        cleanup = getattr(obj, "cleanup", None)
        if callable(cleanup):
            try:
                cleanup()
            except Exception as e:  # pragma: no cover
                logger.debug("cleanup() raised: %s", e)
    del objects
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def live_device_bytes() -> int:
    """Bytes of live tensors on every card (``torch.cuda.memory_stats``),
    0 without one."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return 0
    return sum(
        int(torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0))
        for i in range(torch.cuda.device_count())
    )
