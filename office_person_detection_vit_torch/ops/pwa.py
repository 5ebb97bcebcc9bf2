"""Piecewise-affine (PWA) and thin-plate-spline (TPS) transforms.

Mirrors ``office_person_detection_vit_tpu/ops/pwa.py``. Fitting stays host
numpy in float64 (``fit_pwa`` triangulates with scipy's Delaunay, ``fit_tps``
solves the full linear system), done once when a transformer is built.
Applying a fitted model is a tensor function on any device:
``pwa_transform`` tests every point against every triangle (barycentric
signs) and takes the nearest centroid among the containing triangles, or
among all of them outside the hull; ``tps_transform`` evaluates the radial
basis. Both are elementwise float32 arithmetic with their sums written out,
so TF32 never enters (geometry needs full float32).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class PWAModel:
    """A fitted piecewise-affine transform (host numpy).

    triangles (T, 3, 2), affines (T, 2, 3) [A | b], centroids (T, 2):
    float32; src_points, dst_points (N, 2) float32: the correspondences.
    """

    triangles: np.ndarray
    affines: np.ndarray
    centroids: np.ndarray
    src_points: np.ndarray
    dst_points: np.ndarray

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[0])

    @property
    def num_points(self) -> int:
        return int(self.src_points.shape[0])


def fit_pwa(src: np.ndarray, dst: np.ndarray) -> PWAModel:
    """Delaunay-triangulate src and solve each triangle's affine exactly."""
    from scipy.spatial import Delaunay

    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    if src.shape != dst.shape or src.ndim != 2 or src.shape[1] != 2:
        raise ValueError("src/dst must both be (N, 2)")
    if src.shape[0] < 3:
        raise ValueError("need >= 3 correspondence points")
    simplices = Delaunay(src).simplices  # (T, 3)
    triangles = src[simplices]  # (T, 3, 2)
    affines = np.zeros((len(simplices), 2, 3), np.float64)
    for t, tri in enumerate(simplices):
        A = np.hstack([src[tri], np.ones((3, 1))])  # [x y 1] @ M.T = dst
        M, *_ = np.linalg.lstsq(A, dst[tri], rcond=None)
        affines[t] = M.T
    return PWAModel(
        triangles=triangles.astype(np.float32),
        affines=affines.astype(np.float32),
        centroids=triangles.mean(axis=1).astype(np.float32),
        src_points=src.astype(np.float32),
        dst_points=dst.astype(np.float32),
    )


def pwa_transform(points: torch.Tensor, triangles: torch.Tensor, affines: torch.Tensor,
                  centroids: torch.Tensor) -> torch.Tensor:
    """(N, 2) points -> (N, 2): each point takes the affine of the nearest
    centroid among the triangles that contain it, or among all triangles
    where none does (extrapolation outside the hull)."""
    p = points[:, None, :]  # (N, 1, 2)
    a = triangles[None, :, 0, :]  # (1, T, 2)
    v0 = triangles[None, :, 2, :] - a
    v1 = triangles[None, :, 1, :] - a
    v2 = p - a

    def dot(s, t):
        return s[..., 0] * t[..., 0] + s[..., 1] * t[..., 1]

    d00, d01, d11 = dot(v0, v0), dot(v0, v1), dot(v1, v1)
    d20, d21 = dot(v2, v0), dot(v2, v1)
    denom = d00 * d11 - d01 * d01
    safe = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    u = (d11 * d20 - d01 * d21) / safe
    v = (d00 * d21 - d01 * d20) / safe
    eps = 1e-7
    inside = (u >= -eps) & (v >= -eps) & (u + v <= 1 + eps) & (denom.abs() > 1e-12)

    off = p - centroids[None]
    dist2 = dot(off, off)  # (N, T)
    tri_idx = torch.argmin(torch.where(inside, dist2, dist2 + 1e30), dim=-1)  # (N,)
    M = affines[tri_idx]  # (N, 2, 3)
    x, y = points[:, None, 0], points[:, None, 1]
    return M[:, :, 0] * x + M[:, :, 1] * y + M[:, :, 2]


@dataclass(frozen=True)
class TPSModel:
    """A fitted thin-plate spline: control (N, 2) points normalised to O(1)
    by (offset, scale), kernel weights w (N, 2) and the affine part a (3, 2),
    float32, so that a float32 evaluation stays well conditioned."""

    control: np.ndarray
    w: np.ndarray
    a: np.ndarray
    offset: np.ndarray  # (2,)
    scale: float


def fit_tps(src: np.ndarray, dst: np.ndarray, reg: float = 0.0) -> TPSModel:
    """The standard TPS solve (phi(r) = r^2 log r) in float64."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    N = src.shape[0]
    if N < 3:
        raise ValueError("need >= 3 control points")
    offset = src.mean(axis=0)
    scale = float(max(np.abs(src - offset).max(), 1e-9))
    src = (src - offset) / scale
    d2 = np.sum((src[:, None, :] - src[None, :, :]) ** 2, -1)
    K = np.where(d2 > 0, d2 * np.log(np.maximum(d2, 1e-300)) * 0.5, 0.0)  # r^2 log r
    if reg:
        K = K + reg * np.eye(N)
    P = np.hstack([np.ones((N, 1)), src])  # (N, 3)
    L = np.zeros((N + 3, N + 3))
    L[:N, :N] = K
    L[:N, N:] = P
    L[N:, :N] = P.T
    rhs = np.zeros((N + 3, 2))
    rhs[:N] = dst
    sol = np.linalg.solve(L, rhs)
    return TPSModel(
        control=src.astype(np.float32),
        w=sol[:N].astype(np.float32),
        a=sol[N:].astype(np.float32),
        offset=offset.astype(np.float32),
        scale=scale,
    )


def tps_transform(points: torch.Tensor, control: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                  offset: torch.Tensor, scale: torch.Tensor | float) -> torch.Tensor:
    """(M, 2) raw pixels -> (M, 2): normalise by (offset, scale), then
    sum_n phi(|p - c_n|) w_n + [1, x, y] a, with phi(r) = r^2 log r. The
    kernel sum over the N control points is an elementwise product and a
    sum, not a matmul."""
    pts = (points - offset[None, :]) / scale
    diff = pts[:, None, :] - control[None, :, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]  # (M, N)
    phi = torch.where(d2 > 0, 0.5 * d2 * torch.log(d2.clamp(min=1e-30)), torch.zeros_like(d2))
    kernel = (phi[:, :, None] * w[None, :, :]).sum(dim=1)  # (M, 2)
    return kernel + (a[0][None, :] + pts[:, :1] * a[1][None, :] + pts[:, 1:] * a[2][None, :])
