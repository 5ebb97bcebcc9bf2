"""Homography estimation on the device: normalized DLT and batched RANSAC.

Mirrors ``office_person_detection_vit_tpu/ops/homography_fit.py``, the
on-device replacement for the estimators the reference tools call:
``cv2.findHomography(..., cv2.RANSAC, 5.0)`` in
``tools/correspondence_analyzer.py:124`` and Kornia's
``find_homography_dlt`` in ``tools/poc_deep_homography.py:43-51``.

Instead of a sequential RANSAC loop, every hypothesis is solved at once:
each iteration's 4-point minimal sample is drawn up front from a
``torch.Generator`` seeded with ``seed`` (on the host, so that the card and
the CPU draw the same samples), one batched ``torch.linalg.svd`` solves all
candidate homographies, the inlier counts are one reduction, and the winner
is refit on its inliers with the masked DLT. Everything runs in float32 with
TF32 off (``device.full_float32``), the port's form of JAX's
``default_matmul_precision("highest")``: geometry must not lose mantissa.

The draws cannot be ``jax.random.choice``'s, so the hypotheses differ from
the JAX package's; on data whose inliers are unambiguous both find the same
inlier set.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import full_float32, resolve_device


def _normalization(points: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Hartley normalization of (..., N, 2) points weighted by (..., N):
    the weighted centroid to the origin, the mean distance to sqrt(2).
    (..., 3, 3)."""
    n = w.sum(-1).clamp_min(1.0)
    centroid = (points * w[..., None]).sum(-2) / n[..., None]
    d = torch.linalg.norm(points - centroid[..., None, :], dim=-1)
    s = math.sqrt(2.0) / ((d * w).sum(-1) / n).clamp_min(1e-8)
    t = torch.zeros(*s.shape, 3, 3, dtype=points.dtype, device=points.device)
    t[..., 0, 0] = s
    t[..., 1, 1] = s
    t[..., 0, 2] = -s * centroid[..., 0]
    t[..., 1, 2] = -s * centroid[..., 1]
    t[..., 2, 2] = 1.0
    return t


def _dlt(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Masked normalized DLT over the leading batch dims: src/dst (..., N,
    2), weights (..., N) -> H (..., 3, 3) with H[2, 2] == 1 (NaN or inf
    for degenerate input). Rows of weight 0 constrain nothing."""
    t_src, t_dst = _normalization(src, w), _normalization(dst, w)
    ones = torch.ones_like(src[..., :1])
    sh = torch.cat([src, ones], -1) @ t_src.transpose(-1, -2)
    dh = torch.cat([dst, ones], -1) @ t_dst.transpose(-1, -2)
    x, y, u, v = sh[..., 0], sh[..., 1], dh[..., 0], dh[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    rows_u = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1)
    rows_v = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    a = torch.cat([rows_u, rows_v], -2) * torch.cat([w, w], -1)[..., None]
    if a.shape[-2] < 9:  # a minimal sample's 8 rows: one zero row keeps the null vector in Vh
        a = torch.cat([a, a.new_zeros(*a.shape[:-2], 9 - a.shape[-2], 9)], -2)
    # h: the right singular vector of the smallest singular value.
    _, _, vh = torch.linalg.svd(a, full_matrices=False)
    h = torch.linalg.inv(t_dst) @ vh[..., -1, :].reshape(*vh.shape[:-2], 3, 3) @ t_src
    return h / h[..., 2:3, 2:3]


def _transfer_errors(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Forward transfer error of each point under each H: h (..., 3, 3),
    src/dst (N, 2) -> (..., N)."""
    p = torch.cat([src, torch.ones_like(src[:, :1])], -1) @ h.transpose(-1, -2)
    z = p[..., 2:3]
    z = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    return torch.linalg.norm(p[..., :2] / z - dst, dim=-1)


def _points(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a), dtype=torch.float32, device=device)


def fit_homography_dlt(src, dst, mask=None, device: torch.device | str = "auto") -> torch.Tensor:
    """Least-squares homography from (N >= 4, 2) correspondences (DLT),
    one SVD on ``device``: the counterpart of Kornia's
    ``find_homography_dlt`` (reference tools/poc_deep_homography.py:43-51).
    ``mask`` (N,) bool keeps a subset."""
    dev = resolve_device(str(device))
    src, dst = _points(src, dev), _points(dst, dev)
    w = torch.ones(src.shape[0], device=dev) if mask is None else torch.as_tensor(mask, device=dev).float()
    with full_float32():
        return _dlt(src, dst, w)


def sample_hypotheses(n: int, iterations: int, seed: int) -> torch.Tensor:
    """(iterations, 4) distinct point indices a row, drawn on the host from
    ``torch.Generator().manual_seed(seed)``: the first 4 of a uniformly
    random permutation of ``range(n)``."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.rand(iterations, n, generator=g).argsort(dim=1)[:, :4]


def fit_homography_ransac(src, dst, threshold: float = 5.0, iterations: int = 512, seed: int = 0,
                          device: torch.device | str = "auto") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RANSAC homography on ``device``: (H (3, 3), inlier mask (N,),
    transfer errors (N,)).

    The behaviour of the reference's ``cv2.findHomography(src, dst,
    cv2.RANSAC, 5.0)`` (tools/correspondence_analyzer.py:124), with every
    hypothesis solved in one batch: a degenerate (non-finite) hypothesis
    counts no inliers, the first of the largest counts wins, and the winner
    is refit on its inliers (cv2's final least-squares polish)."""
    dev = resolve_device(str(device))
    src, dst = _points(src, dev), _points(dst, dev)
    n = src.shape[0]
    if n < 4:
        raise ValueError(f"need >=4 correspondences, got {n}")
    idx = sample_hypotheses(n, iterations, seed).to(dev)
    with full_float32():
        hyp = _dlt(src[idx], dst[idx], torch.ones(idx.shape, device=dev))  # (iterations, 3, 3)
        err = _transfer_errors(hyp, src, dst)
        inl = (err < threshold) & torch.isfinite(err)
        counts = torch.where(torch.isfinite(hyp).flatten(1).all(1), inl.sum(1), 0)
        best = inl[torch.argmax(counts)]
        h = _dlt(src, dst, best.float())
        err = _transfer_errors(h, src, dst)
    return h, (err < threshold) & torch.isfinite(err), err
