"""Homography on tensors.

Mirrors the homography part of ``office_person_detection_vit_tpu/ops/geometry.py``:
``validate_homography`` (host) and ``homography_transform``. The transform
runs in the dtype of its inputs; callers hand it float32 as the JAX package
does, with TF32 off (it uses no matmul).
"""

from __future__ import annotations

import numpy as np
import torch


def validate_homography(H) -> None:
    """Raise on a homography that is not 3x3, singular or ill-conditioned."""
    H = np.asarray(H, dtype=np.float64)
    if H.shape != (3, 3):
        raise ValueError(f"homography must be 3x3, got {H.shape}")
    det = np.linalg.det(H)
    if abs(det) < 1e-10:
        raise ValueError(f"homography is singular (det={det:.3e})")
    cond = np.linalg.cond(H)
    if cond > 1e12:
        raise ValueError(f"homography is ill-conditioned (cond={cond:.3e})")


def homography_transform(H: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(x', y', w) = H @ (x, y, 1) for (..., 2) points -> (x'/w, y'/w)."""
    x = points[..., 0]
    y = points[..., 1]
    xp = H[0, 0] * x + H[0, 1] * y + H[0, 2]
    yp = H[1, 0] * x + H[1, 1] * y + H[1, 2]
    w = H[2, 0] * x + H[2, 1] * y + H[2, 2]
    w = torch.where(w.abs() < 1e-12, torch.sign(w) * 1e-12 + (w == 0) * 1e-12, w)
    return torch.stack([xp / w, yp / w], dim=-1)
