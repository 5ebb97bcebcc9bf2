"""Zone-count aggregation on tensors.

Mirrors ``office_person_detection_vit_tpu/ops/aggregation.py``: the run's
zone counts as one (F, Z) reduction of the (F, Q, Z) membership
(``zone_count_matrix``, ``unclassified_counts``), and the per-zone
statistics, least-squares trend and occupancy peaks over it, in float32.
"""

from __future__ import annotations

import torch


def zone_count_matrix(membership: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(F, Q, Z) bool membership x (F, Q) bool valid -> (F, Z) int32 counts;
    a detection inside several zones counts once in each."""
    return (membership & valid[..., None]).sum(dim=1, dtype=torch.int32)


def unclassified_counts(membership: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(F, Q, Z), (F, Q) -> (F,) int32 number of valid detections in no zone."""
    return (~membership.any(dim=-1) & valid).sum(dim=-1, dtype=torch.int32)


def zone_statistics(counts: torch.Tensor) -> dict[str, torch.Tensor]:
    """(F, Z) -> per-zone average, max, min, std (population), median, q1 and
    q3, each (Z,) float32. The quantiles interpolate linearly between order
    statistics, as ``jnp.percentile`` does (``torch.median`` would take the
    lower middle)."""
    c = counts.float()
    q = torch.tensor([0.5, 0.25, 0.75], device=c.device)
    median, q1, q3 = torch.quantile(c, q, dim=0)
    return {
        "average": c.mean(dim=0),
        "max": c.amax(dim=0),
        "min": c.amin(dim=0),
        "std": c.std(dim=0, correction=0),
        "median": median,
        "q1": q1,
        "q3": q3,
    }


def linear_trend(counts: torch.Tensor) -> dict[str, torch.Tensor]:
    """Least-squares slope, intercept and R^2 of each zone's counts over the
    frame index: (F, Z) -> (Z,) each."""
    F = counts.shape[0]
    t = torch.arange(F, dtype=torch.float32, device=counts.device)
    y = counts.float()
    t_mean = t.mean()
    y_mean = y.mean(dim=0)
    t_c = t - t_mean
    y_c = y - y_mean[None, :]
    denom = (t_c**2).sum()
    slope = (t_c[:, None] * y_c).sum(dim=0) / denom.clamp(min=1e-12)
    intercept = y_mean - slope * t_mean
    y_pred = slope[None, :] * t[:, None] + intercept[None, :]
    ss_res = ((y - y_pred) ** 2).sum(dim=0)
    ss_tot = (y_c**2).sum(dim=0)
    r2 = torch.where(ss_tot > 1e-12, 1.0 - ss_res / ss_tot, torch.zeros_like(ss_tot))
    return {"slope": slope, "intercept": intercept, "r_squared": r2}


def top_k_peaks(counts: torch.Tensor, k: int = 5) -> tuple[torch.Tensor, torch.Tensor]:
    """(F, Z) -> (frame indices, totals) of the k frames of most total
    occupancy, largest first; equal totals keep frame order (a stable sort,
    as ``jax.lax.top_k`` breaks ties)."""
    totals = counts.sum(dim=-1)
    k = min(k, totals.shape[0])
    vals, idxs = torch.sort(totals, descending=True, stable=True)
    return idxs[:k], vals[:k]
