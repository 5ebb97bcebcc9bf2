"""Appearance features of detections.

Mirrors ``office_person_detection_vit_tpu/detection/features.py``:
``roi_mean_pool`` averages the encoder cells under each box of a whole
(B, Q) batch at once and L2-normalises the result (a tensor function on the
encoder's device); ``crop_histogram_features`` is the host fallback for
boxes without encoder features (64-bin BGR histograms and channel
statistics, padded to 256).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import full_float32


def roi_mean_pool(enc_features: torch.Tensor, feature_hw: tuple[int, int], boxes_xywh: torch.Tensor,
                  valid: torch.Tensor, image_wh: torch.Tensor) -> torch.Tensor:
    """enc_features (B, L, C) flattened encoder output; boxes_xywh (B, Q, 4)
    and image_wh (2,) in original-image pixels; valid (B, Q) -> (B, Q, C)
    float32, L2-normalised, zero where not valid.

    A cell counts under a box when its centre lies within half a cell of
    the box's corners on the feature grid. The sum over cells is a batched
    matmul in float32 with TF32 off.
    """
    fh, fw = feature_hw
    B, L, C = enc_features.shape
    feats = enc_features.reshape(B, fh * fw, C).float()
    sx = fw / image_wh[0]
    sy = fh / image_wh[1]
    x0 = boxes_xywh[..., 0] * sx
    y0 = boxes_xywh[..., 1] * sy
    x1 = (boxes_xywh[..., 0] + boxes_xywh[..., 2]) * sx
    y1 = (boxes_xywh[..., 1] + boxes_xywh[..., 3]) * sy
    cy = torch.arange(fh, dtype=torch.float32, device=feats.device) + 0.5  # cell centres
    cx = torch.arange(fw, dtype=torch.float32, device=feats.device) + 0.5
    in_y = (cy >= y0[..., None] - 0.5) & (cy <= y1[..., None] + 0.5)  # (B, Q, fh)
    in_x = (cx >= x0[..., None] - 0.5) & (cx <= x1[..., None] + 0.5)  # (B, Q, fw)
    cell_mask = (in_y[..., :, None] & in_x[..., None, :]).float().reshape(B, -1, fh * fw)
    with full_float32():
        pooled = torch.bmm(cell_mask, feats)  # (B, Q, C)
    pooled = pooled / cell_mask.sum(dim=-1).clamp(min=1.0)[..., None]
    pooled = pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.where(valid[..., None], pooled, torch.zeros_like(pooled))


def crop_histogram_features(frame: np.ndarray, boxes_xywh: np.ndarray, dim: int = 256) -> np.ndarray:
    """Per box: 64-bin histograms of each BGR channel and the channels' mean
    and std, padded (or cut) to ``dim`` and L2-normalised; zeros for a box
    with no pixels inside the frame."""
    H, W = frame.shape[:2]
    out = np.zeros((len(boxes_xywh), dim), np.float32)
    for i, (x, y, w, h) in enumerate(boxes_xywh):
        x0, y0 = max(0, int(x)), max(0, int(y))
        x1, y1 = min(W, int(x + w)), min(H, int(y + h))
        if x1 <= x0 or y1 <= y0:
            continue
        crop = frame[y0:y1, x0:x1].reshape(-1, 3).astype(np.float32)
        hists = [np.histogram(crop[:, c], bins=64, range=(0, 256))[0].astype(np.float32) for c in range(3)]
        v = np.concatenate(hists + [np.concatenate([crop.mean(axis=0), crop.std(axis=0)])])
        if len(v) < dim:
            v = np.pad(v, (0, dim - len(v)))
        v = v[:dim]
        n = np.linalg.norm(v)
        out[i] = v / n if n > 1e-12 else v
    return out
