"""Data-parallel detection over the ranks of a (data, model) grid.

Mirrors ``office_person_detection_vit_tpu/parallel/inference.py``: the frame
batch splits over the data ranks (each rank detects its slice) and the
results are gathered, so every rank returns the whole batch's detections;
the parameters are replicated, or split over the model ranks by
``parallel/sharding.py``'s rules (``tensor_parallel``). On a 1x1 grid this is
the one-device program. Every rank calls the detect function with the whole
batch, as a JAX program under ``jit`` takes the global array.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..core.dto import DetectionBatch
from ..models.postprocess import postprocess_detr
from ..ops.preprocessing import preprocess_frames
from .mesh import Mesh, batch_sharding
from .sharding import shard_model


def detect_shardings(model, mesh: Mesh, tensor_parallel: bool = False) -> tuple:
    """(the model, the frame axis's placement) for the detect program: with
    ``tensor_parallel`` the model split in place over the model ranks by the
    tensor-parallel rules (``shard_model``), whole otherwise; the placement
    is ``batch_sharding(mesh)``, this rank's slice of the frame batch.
    Shared by :func:`make_sharded_detect` and ``DETRDetector``."""
    if tensor_parallel:
        shard_model(model, mesh)
    return model, batch_sharding(mesh)


def gather_detections(batch: DetectionBatch, mesh: Mesh, extra: torch.Tensor | None = None):
    """The whole batch's detections (host arrays, in rank order) from each
    data rank's slice, and, given ``extra`` (a per-frame tensor such as the
    encoder output), its gathered tensor too."""
    group = mesh.data_group().group
    if group is None:
        return batch, extra
    parts: list = [None] * mesh.data_parallel
    dist.all_gather_object(parts, batch, group=group)
    merged = DetectionBatch(**{name: np.concatenate([np.asarray(getattr(p, name)) for p in parts])
                               for name in ("boxes_xywh", "scores", "valid", "foot")})
    if extra is not None:
        pieces = [torch.empty_like(extra) for _ in range(mesh.data_parallel)]
        dist.all_gather(pieces, extra.contiguous(), group=group)
        extra = torch.cat(pieces)
    return merged, extra


def make_sharded_detect(model, mesh: Mesh, target_hw: tuple[int, int], confidence_threshold: float,
                        tensor_parallel: bool = False) -> Callable:
    """-> fn(frames_u8 (F, H, W, 3) uint8 tensor, orig_wh) -> DetectionBatch
    of all F frames, each data rank detecting its F / data slice (F must
    divide by the data axis). With ``tensor_parallel`` the model is split
    over the model ranks first (in place)."""
    person = model.config.person_class_id
    model, place_frames = detect_shardings(model, mesh, tensor_parallel)

    @torch.inference_mode()
    def detect(frames_u8: torch.Tensor, orig_wh) -> DetectionBatch:
        local = place_frames(frames_u8)
        pixels, mask = preprocess_frames(local, target_hw=target_hw, out_dtype=model.config.torch_dtype)
        out = model(pixels, mask)
        batch = postprocess_detr(out["logits"], out["boxes"], orig_wh, confidence_threshold,
                                 person_class_id=person, score_mode=model.config.score_mode)
        return gather_detections(batch, mesh)[0]

    return detect
