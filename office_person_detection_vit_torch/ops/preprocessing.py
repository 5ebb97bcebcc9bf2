"""Frame preprocessing for the detector (the BGR route).

Mirrors ``office_person_detection_vit_tpu/ops/preprocessing.py``:
``compute_resize_geometry`` and ``preprocess_frames``. uint8 BGR frames ->
RGB, /255, ImageNet normalization, aspect-preserving bilinear resize, then
bottom/right zero padding and a validity mask. The I420 routes wait for a
later slice.

Resize: ``jax.image.resize(..., "bilinear")`` widens its triangle filter
when it downsamples (antialiasing); ``F.interpolate(..., antialias=True)``
does the same, and the two agree to 4.8e-7 (float32 rounding) at the 0.3x
downsample of 720p into 224x384 (tests/test_torch_preprocess_boxes.py). 720p into
736x1280 is scale 1.0 and is padding only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def compute_resize_geometry(src_hw: tuple[int, int], dst_hw: tuple[int, int]) -> tuple[int, int]:
    """Aspect-preserving target size (h, w) fitting src into dst."""
    sh, sw = src_hw
    dh, dw = dst_hw
    scale = min(dh / sh, dw / sw)
    return (min(dh, round(sh * scale)), min(dw, round(sw * scale)))


def preprocess_frames(
    frames: torch.Tensor,
    target_hw: tuple[int, int] = (736, 1280),
    out_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(F, H, W, 3) uint8 BGR -> (pixel_values (F, th, tw, 3) RGB-normalized,
    pixel_mask (F, th, tw) bool)."""
    n, H, W, _ = frames.shape
    th, tw = target_hw
    rh, rw = compute_resize_geometry((H, W), (th, tw))

    x = frames.to(torch.float32).flip(-1) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    x = (x - mean) / std

    if (rh, rw) != (H, W):
        x = F.interpolate(
            x.permute(0, 3, 1, 2), size=(rh, rw), mode="bilinear",
            align_corners=False, antialias=True,
        ).permute(0, 2, 3, 1)
    x = F.pad(x, (0, 0, 0, tw - rw, 0, th - rh))

    mask = torch.zeros((n, th, tw), dtype=torch.bool, device=x.device)
    mask[:, :rh, :rw] = True
    return x.to(out_dtype).contiguous(), mask
