"""Training augmentation on the card, inside the train step.

Mirrors ``office_person_detection_vit_tpu/training/augment.py``: a few
vectorized ops on the batch already on the device, drawn per sample from the
step's generator (a CPU ``torch.Generator``, the counterpart of the step's
PRNG key; its draws are not JAX's).

- Horizontal flip (probability ``hflip_prob``), box-aware: normalized
  cx -> 1 - cx. Letterbox-aware: with ``content_w`` set, only the valid
  content columns are mirrored (flip the whole canvas, then roll the right
  edge padding back), so the pixel mask and the boxes' normalization to the
  valid area stay as they are.
- Photometric jitter: per-sample contrast (multiplicative) and brightness
  (additive) on the ImageNet-normalized tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.preprocessing import compute_resize_geometry


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    hflip_prob: float = 0.5
    brightness: float = 0.2
    contrast: float = 0.2
    #: Width in pixels of the letterboxed valid content; None = the whole
    #: canvas (no horizontal padding).
    content_w: int | None = None


def augment_batch(generator: torch.Generator, batch: dict, cfg: AugmentConfig) -> dict:
    """A new batch dict with augmented ``pixels`` (B, H, W, 3) and ``boxes``
    (B, T, 4) cxcywh; ``pixel_mask`` (geometry-invariant) passes through."""
    pixels = batch["pixels"]
    boxes = batch["boxes"]
    B, _, W, _ = pixels.shape
    flip = torch.rand(B, generator=generator) < cfg.hflip_prob
    c = torch.empty(B).uniform_(-cfg.contrast, cfg.contrast, generator=generator)
    b = torch.empty(B).uniform_(-cfg.brightness, cfg.brightness, generator=generator)
    flip, c, b = (t.to(pixels.device) for t in (flip, c, b))

    flipped = pixels.flip(2)
    if cfg.content_w is not None and cfg.content_w != W:
        flipped = torch.roll(flipped, shifts=-(W - cfg.content_w), dims=2)
    pixels = torch.where(flip[:, None, None, None], flipped, pixels)
    cx = torch.where(flip[:, None], 1.0 - boxes[..., 0], boxes[..., 0])
    boxes = torch.cat([cx[..., None], boxes[..., 1:]], dim=-1)

    pixels = pixels * (1.0 + c[:, None, None, None]).to(pixels.dtype)
    pixels = pixels + b[:, None, None, None].to(pixels.dtype)
    out = dict(batch)
    out["pixels"] = pixels
    out["boxes"] = boxes
    return out


def content_width(target_hw: tuple[int, int], source_wh: tuple[int, int] = (1280, 720)) -> int:
    """Letterbox content width for ``content_w``: the valid columns after an
    aspect-preserving resize of a ``source_wh`` frame into ``target_hw``."""
    sw, sh = source_wh
    _, rw = compute_resize_geometry((sh, sw), target_hw)
    return rw
