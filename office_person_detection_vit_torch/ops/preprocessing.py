"""Frame preprocessing for the detector: the BGR route and the device half of
the I420 routes.

Mirrors ``office_person_detection_vit_tpu/ops/preprocessing.py``:
``compute_resize_geometry`` and ``preprocess_frames`` (uint8 BGR frames ->
RGB, /255, ImageNet normalization, aspect-preserving bilinear resize, then
bottom/right zero padding and a validity mask), ``preprocess_frames_i420``
(:107-149: I420 planes -> BT.601 RGB with nearest 2x chroma, then the same)
and ``reconstruct_i420_delta`` (:179-187: the inverse of the host's XOR
delta). The host half (BGR -> I420, the delta) is ``ops/staging.py``.

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
    return _normalize_resize_pad(frames.to(torch.float32).flip(-1) / 255.0, target_hw, out_dtype)


def _normalize_resize_pad(x: torch.Tensor, target_hw: tuple[int, int], out_dtype: torch.dtype):
    """(F, H, W, 3) float32 RGB in [0, 1] -> ImageNet-normalized, resized and
    padded pixels and their validity mask (the tail of both routes)."""
    n, H, W, _ = x.shape
    th, tw = target_hw
    rh, rw = compute_resize_geometry((H, W), (th, tw))
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


def preprocess_frames_i420(
    planes: torch.Tensor,
    target_hw: tuple[int, int] = (736, 1280),
    out_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(F, H*3//2, W) uint8 I420 -> the contract of :func:`preprocess_frames`.

    BT.601 studio swing to RGB with cv2's I420 constants (Y in [16, 235],
    chroma in [16, 240]) and nearest 2x chroma, clipped to [0, 1], then the
    BGR route's normalization, resize and padding."""
    n, HH, W = planes.shape
    H = HH * 2 // 3
    y = planes[:, :H, :].to(torch.float32)
    # After the Y plane: U then V, each (H/2, W/2), stored as (H/4, W) rows.
    chroma = planes[:, H:, :].reshape(n, 2, H // 4, W)
    u = chroma[:, 0].reshape(n, H // 2, W // 2)
    v = chroma[:, 1].reshape(n, H // 2, W // 2)
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2).to(torch.float32)
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2).to(torch.float32)
    yy = 1.163999557 * (y - 16.0)
    cb = u - 128.0
    cr = v - 128.0
    r = yy + 1.595999718 * cr
    g = yy - 0.390999794 * cb - 0.812999725 * cr
    b = yy + 2.017999649 * cb
    x = (torch.stack([r, g, b], dim=-1) / 255.0).clamp(0.0, 1.0)
    return _normalize_resize_pad(x, target_hw, out_dtype)


def reconstruct_i420_delta(deltas: torch.Tensor, prev_last: torch.Tensor) -> torch.Tensor:
    """Inverse of the host's XOR delta (``ops/staging.py::i420_delta_encode``):
    an inclusive XOR scan over the frame axis gives frame i XOR ``prev_last``,
    and one more XOR with ``prev_last`` the frames, exactly. torch has no
    cumulative XOR, so the scan doubles its step (log2 F passes)."""
    x = deltas
    step = 1
    while step < x.shape[0]:
        x = torch.cat([x[:step], x[step:] ^ x[:-step]])
        step *= 2
    return x ^ prev_last[None]
