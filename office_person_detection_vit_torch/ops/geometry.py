"""Floor geometry on tensors.

Mirrors ``office_person_detection_vit_tpu/ops/geometry.py``:
``validate_homography`` (host), ``homography_transform``, ``px_to_mm``,
``in_bounds_mask``, the Brown lens model (``undistort_points``,
``distort_points``) and ``reprojection_errors``. Every function is
elementwise arithmetic in the dtype of its inputs (no matmul, so TF32 never
enters); callers hand it float32 as the JAX package does.
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


def px_to_mm(points_px: torch.Tensor, origin: torch.Tensor, mm_per_px: torch.Tensor) -> torch.Tensor:
    """Floormap pixels -> millimetres: (px - origin) * mm_per_px, per axis."""
    return (points_px - origin) * mm_per_px


def in_bounds_mask(points: torch.Tensor, width: float, height: float) -> torch.Tensor:
    """(..., 2) -> bool mask of the points inside [0, width) x [0, height)."""
    x = points[..., 0]
    y = points[..., 1]
    return (x >= 0) & (x < width) & (y >= 0) & (y < height)


def _brown(camera_matrix: torch.Tensor, dist_coeffs: torch.Tensor):
    """(fx, fy, cx, cy) and (k1, k2, p1, p2, k3) as 0-d tensors."""
    K = camera_matrix
    return (K[0, 0], K[1, 1], K[0, 2], K[1, 2]), tuple(dist_coeffs[i] for i in range(5))


def undistort_points(points: torch.Tensor, camera_matrix: torch.Tensor, dist_coeffs: torch.Tensor,
                     num_iters: int = 10) -> torch.Tensor:
    """Invert the Brown radial + tangential model by ``num_iters`` fixed-point
    steps (cv2.undistortPoints' iteration). points (..., 2) distorted pixels;
    camera_matrix (3, 3) K; dist_coeffs (5,) [k1, k2, p1, p2, k3]."""
    (fx, fy, cx, cy), (k1, k2, p1, p2, k3) = _brown(camera_matrix, dist_coeffs)
    xd = (points[..., 0] - cx) / fx
    yd = (points[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(num_iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (xd - dx) / radial, (yd - dy) / radial
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)


def distort_points(points: torch.Tensor, camera_matrix: torch.Tensor, dist_coeffs: torch.Tensor) -> torch.Tensor:
    """The forward Brown model: undistorted pixels -> distorted pixels."""
    (fx, fy, cx, cy), (k1, k2, p1, p2, k3) = _brown(camera_matrix, dist_coeffs)
    x = (points[..., 0] - cx) / fx
    y = (points[..., 1] - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd * fx + cx, yd * fy + cy], dim=-1)


def reprojection_errors(H: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Per-point L2 distance of H(src) from dst."""
    d = homography_transform(H, src) - dst
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
