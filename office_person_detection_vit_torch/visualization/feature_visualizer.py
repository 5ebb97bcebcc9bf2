"""Re-ID feature-space diagnostics (reference
src/visualization/feature_visualizer.py:42-254).

Mirrors ``office_person_detection_vit_tpu/visualization/feature_visualizer.py``:
t-SNE projection, KMeans clustering and the silhouette of appearance
features, for judging whether Re-ID features separate identities. The JAX
package calls sklearn on the host; here each is written in torch and runs
on ``device`` (the card unless asked for the CPU), in float64, with
sklearn's settings as the JAX package uses them:

- :func:`tsne`: exact t-SNE (the whole (N, N) affinity matrix): a
  perplexity found row by row by bisection on the Gaussian's precision
  (100 steps, tolerance 1e-5), the joint P symmetrised and floored at
  float64's epsilon, a PCA start scaled to a standard deviation of 1e-4,
  the Student-t (one degree of freedom) gradient, 250 iterations with P
  exaggerated 12 times and momentum 0.5, then momentum 0.8 up to 1,000,
  per-coordinate gains (+0.2 / x0.8, floor 0.01), learning rate
  max(N / 48, 50), and sklearn's stops (no progress for 250 / 300
  iterations, gradient norm 1e-7, checked every 50);
- :func:`kmeans`: k-means++ seeding (2 + ln k local trials) and Lloyd
  iterations (at most 300, tolerance 1e-4 of the mean feature variance, a
  stop on unchanged labels), the best of ``n_init`` runs by inertia; a
  cluster left empty keeps its centre;
- :func:`silhouette`: the mean silhouette over samples (0 for a sample
  alone in its cluster).

The random draws come from a ``torch.Generator`` seeded with
``random_state``, drawn on the host, so the card and the CPU draw the same.
The plot is drawn with OpenCV (``visualizer.scatter_chart``).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from .visualizer import _COLORS, scatter_chart

_EPS = float(np.finfo(np.float64).eps)
EARLY_EXAGGERATION, EXPLORATION_ITER, MAX_ITER, ITER_CHECK = 12.0, 250, 1000, 50


def _sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, D), (N, D) -> (M, N) squared distances, by differences."""
    return torch.cdist(a, b, compute_mode="donot_use_mm_for_euclid_dist") ** 2


def squared_distances(x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (N, N) squared Euclidean distances, by differences (no
    ||x||^2 - 2xy cancellation)."""
    return _sq(x, x)


def joint_probabilities(d2: torch.Tensor, perplexity: float, steps: int = 100, tol: float = 1e-5) -> torch.Tensor:
    """t-SNE's joint P from squared distances: each row's conditional
    Gaussian at the precision whose entropy is ln(perplexity), found by
    bisection on all rows at once (a row keeps the precision at which it
    converged, or its last one), then (P + P^T) / sum, floored at epsilon
    off the diagonal."""
    n = d2.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=d2.device)
    beta = torch.ones(n, dtype=d2.dtype, device=d2.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=d2.device)
    target = math.log(perplexity)
    for step in range(steps):
        p = torch.exp(-d2 * beta[:, None]) * off
        s = p.sum(1)
        s = torch.where(s == 0, torch.full_like(s, 1e-8), s)
        entropy = torch.log(s) + beta * (d2 * p).sum(1) / s
        diff = entropy - target
        done |= diff.abs() <= tol
        if step == steps - 1 or bool(done.all()):
            break
        up, down = (diff > 0) & ~done, (diff <= 0) & ~done
        new_up = torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0)
        new_down = torch.where(torch.isinf(lo), beta / 2.0, (beta + lo) / 2.0)
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = torch.where(up, new_up, torch.where(down, new_down, beta))
    cond = p / s[:, None]
    joint = cond + cond.T
    joint = joint / joint.sum().clamp_min(_EPS)
    return torch.where(off, joint.clamp_min(_EPS), torch.zeros_like(joint))


def kl_divergence(P: torch.Tensor, y: torch.Tensor, with_grad: bool = True, with_error: bool = True):
    """KL(P || Q) of an embedding ``y`` (N, 2) under Student-t affinities
    (one degree of freedom), and its gradient: each None where not asked
    for."""
    n = y.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=y.device)
    d = y[:, None, :] - y[None, :, :]
    w = torch.where(off, 1.0 / (1.0 + (d * d).sum(-1)), torch.zeros((), dtype=y.dtype, device=y.device))
    q = torch.where(off, (w / w.sum()).clamp_min(_EPS), torch.zeros_like(w))
    kl = None
    if with_error:
        kl = torch.where(off, P * torch.log(P.clamp_min(_EPS) / q.clamp_min(_EPS)), torch.zeros_like(P)).sum()
    if not with_grad:
        return kl, None
    pqd = (P - q) * w
    return kl, 4.0 * (pqd.sum(1)[:, None] * y - pqd @ y)


def pca_init(x: torch.Tensor) -> torch.Tensor:
    """The first two principal components of ``x`` (signs as sklearn's
    ``svd_flip`` on V), scaled so that the first has standard deviation
    1e-4."""
    xc = x - x.mean(0)
    u, s, vh = torch.linalg.svd(xc, full_matrices=False)
    sign = torch.sign(vh[:2].gather(1, vh[:2].abs().argmax(1, keepdim=True)))
    y = u[:, :2] * s[:2] * sign.T
    return y / y[:, 0].std(correction=0) * 1e-4


def _descent(P, y, start: int, stop: int, momentum: float, lr: float, patience: int) -> tuple[torch.Tensor, int]:
    """sklearn's ``_gradient_descent`` on the exact KL: iterations
    ``start`` .. ``stop - 1`` with gains and momentum; the error and the
    gradient norm are read every ITER_CHECK iterations."""
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    best_error, best_iter, i = math.inf, start, start
    for i in range(start, stop):
        check = (i + 1) % ITER_CHECK == 0
        error, grad = kl_divergence(P, y, with_error=check)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_min(0.01)
        grad = grad * gains
        update = momentum * update - lr * grad
        y = y + update
        if check:
            error, grad_norm = float(error), float(torch.linalg.norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > patience:
                break
            if grad_norm <= 1e-7:
                break
    return y, i


def tsne(x: torch.Tensor, perplexity: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact t-SNE of (N, D) float64 ``x`` -> ((N, 2) embedding, its P)."""
    n = x.shape[0]
    if perplexity >= n:
        raise ValueError("perplexity must be less than n_samples")
    P = joint_probabilities(squared_distances(x), perplexity)
    lr = max(n / EARLY_EXAGGERATION / 4.0, 50.0)
    y, it = _descent(P * EARLY_EXAGGERATION, pca_init(x), 0, EXPLORATION_ITER, 0.5, lr, EXPLORATION_ITER)
    y, _ = _descent(P, y, it + 1, MAX_ITER, 0.8, lr, 300)
    return y, P


def _kmeans_pp(x: torch.Tensor, k: int, g: torch.Generator) -> torch.Tensor:
    """k-means++ seeding (sklearn's ``_kmeans_plusplus``, unit weights)."""
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    first = torch.randint(n, (1,), generator=g).to(x.device)
    centers = [x[first]]
    closest = _sq(centers[0], x)[0]
    pot = closest.sum()
    for _ in range(1, k):
        rand = torch.rand(trials, generator=g, dtype=x.dtype).to(x.device) * pot
        ids = torch.searchsorted(torch.cumsum(closest, 0), rand).clamp_max(n - 1)
        d = torch.minimum(closest, _sq(x[ids], x))  # (trials, N)
        pots = d.sum(1)
        best = torch.argmin(pots)
        pot, closest = pots[best], d[best]
        centers.append(x[ids[best]][None])
    return torch.cat(centers)


def _assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return _sq(x, centers).argmin(1)


def kmeans(x: torch.Tensor, k: int, generator: torch.Generator, n_init: int = 10, max_iter: int = 300,
           tol: float = 1e-4) -> tuple[torch.Tensor, float]:
    """KMeans of (N, D) float64 ``x``: (labels (N,), inertia), the best of
    ``n_init`` k-means++ + Lloyd runs."""
    x = x - x.mean(0)
    tol = float(x.var(0, correction=0).mean()) * tol
    best_labels, best_inertia = None, math.inf
    for _ in range(n_init):
        centers = _kmeans_pp(x, k, generator)
        old = None
        converged = False
        for _ in range(max_iter):
            labels = _assign(x, centers)
            counts = torch.bincount(labels, minlength=k).to(x.dtype)
            sums = torch.zeros_like(centers).index_add_(0, labels, x)
            new = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], centers)
            shift = float(((new - centers) ** 2).sum())
            centers = new
            if old is not None and torch.equal(labels, old):
                converged = True
                break
            if shift <= tol:
                break
            old = labels
        if not converged:
            labels = _assign(x, centers)
        inertia = float(((x - centers[labels]) ** 2).sum())
        if inertia < best_inertia:
            best_labels, best_inertia = labels, inertia
    return best_labels, best_inertia


def silhouette(x: torch.Tensor, labels: torch.Tensor) -> float:
    """Mean silhouette of (N, D) float64 ``x`` under ``labels`` (Euclidean);
    a sample alone in its cluster scores 0. Needs 2 <= clusters <= N - 1."""
    _, inv = torch.unique(labels, return_inverse=True)
    n_labels = int(inv.max()) + 1
    if not 2 <= n_labels <= x.shape[0] - 1:
        raise ValueError(f"Number of labels is {n_labels}. Valid values are 2 to n_samples - 1 (inclusive)")
    d = torch.cdist(x, x, compute_mode="donot_use_mm_for_euclid_dist")
    onehot = torch.nn.functional.one_hot(inv, n_labels).to(x.dtype)
    sums, counts = d @ onehot, onehot.sum(0)
    own = sums.gather(1, inv[:, None])[:, 0]
    a = own / (counts[inv] - 1.0)
    mean_other = (sums / counts).masked_fill(onehot.bool(), math.inf)
    b = mean_other.min(1).values
    s = torch.nan_to_num((b - a) / torch.maximum(a, b))
    return float(s.mean())


class FeatureVisualizer:
    def __init__(self, random_state: int = 0, device: torch.device | str = "auto"):
        self.random_state = random_state
        self.device = resolve_device(str(device))

    def _tensor(self, features) -> torch.Tensor:
        f = features if torch.is_tensor(features) else torch.from_numpy(np.asarray(features))
        return f.to(self.device, torch.float64)

    def project_tsne(self, features: np.ndarray, perplexity: float | None = None) -> np.ndarray:
        """(N, D) -> (N, 2) t-SNE embedding (reference :42), float32."""
        n = len(features)
        if perplexity is None:
            perplexity = max(2.0, min(30.0, (n - 1) / 3))
        y, _ = tsne(self._tensor(features), perplexity)
        return y.cpu().numpy().astype(np.float32)

    def cluster(self, features: np.ndarray, n_clusters: int) -> tuple[np.ndarray, float]:
        """KMeans labels + silhouette score (reference :120-200)."""
        x = self._tensor(features)
        labels, _ = kmeans(x, n_clusters, torch.Generator().manual_seed(self.random_state))
        score = silhouette(x, labels) if 1 < n_clusters < len(features) else 0.0
        return labels.cpu().numpy(), score

    def quality_report(self, features: np.ndarray, track_ids: np.ndarray) -> dict[str, Any]:
        """How well do features separate the true track identities?"""
        ids = np.asarray(track_ids)
        unique = np.unique(ids)
        report: dict[str, Any] = {"num_features": int(len(features)), "num_tracks": int(len(unique))}
        if 1 < len(unique) < len(features):
            report["silhouette_by_track"] = silhouette(self._tensor(features),
                                                       torch.as_tensor(np.searchsorted(unique, ids), device=self.device))
            _, report["silhouette_by_kmeans"] = self.cluster(features, len(unique))
        return report

    def plot_embedding(self, features: np.ndarray, track_ids: np.ndarray, output_path: str | Path) -> Path:
        """t-SNE scatter coloured by track id (reference :200-254), 8 x 8 in
        at 120 dpi; a legend for 20 ids or fewer."""
        emb = self.project_tsne(features)
        ids = np.asarray(track_ids)
        groups = [(f"id {tid}", emb[ids == tid], _COLORS[i % len(_COLORS)], "o")
                  for i, tid in enumerate(np.unique(ids))]
        return scatter_chart(groups, output_path, "Re-ID feature embedding (t-SNE)", (8, 8),
                             legend=len(groups) <= 20)
