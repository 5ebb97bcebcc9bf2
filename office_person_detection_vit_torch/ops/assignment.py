"""Linear assignment for the trackers and the MOT metrics.

Mirrors ``office_person_detection_vit_tpu/ops/assignment.py``:

- :func:`solve_lap`: exact, host scipy ``linear_sum_assignment`` with the
  inf -> 1e9 sanitising and the greedy fall-back on failure;
- :func:`greedy_assignment`: host numpy greedy, which stops at the first
  pick over ``max_cost``;
- :func:`greedy_assignment_device`: the fixed-shape greedy of the scan
  tracker, on the cost tensor's device. It runs exactly min(N, M) rounds and
  does not stop: a pick over ``max_cost`` only closes that one cell.
"""

from __future__ import annotations

import numpy as np
import torch

BIG_COST = 1e9


def _sanitize(cost: np.ndarray) -> np.ndarray:
    cost = np.asarray(cost, np.float64).copy()
    cost[~np.isfinite(cost)] = BIG_COST
    return cost


def greedy_assignment(cost: np.ndarray, max_cost: float | None = None) -> list[tuple[int, int]]:
    """Repeatedly pick the globally cheapest remaining pair."""
    cost = _sanitize(cost)
    N, M = cost.shape
    pairs: list[tuple[int, int]] = []
    used_r = np.zeros(N, bool)
    used_c = np.zeros(M, bool)
    for _ in range(min(N, M)):
        masked = cost.copy()
        masked[used_r, :] = np.inf
        masked[:, used_c] = np.inf
        idx = np.unravel_index(np.argmin(masked), masked.shape)
        if not np.isfinite(masked[idx]):
            break
        if max_cost is not None and masked[idx] > max_cost:
            break
        pairs.append((int(idx[0]), int(idx[1])))
        used_r[idx[0]] = True
        used_c[idx[1]] = True
    return pairs


def solve_lap(cost: np.ndarray) -> list[tuple[int, int]]:
    """Exact LAP through scipy, with the greedy fall-back."""
    if cost.size == 0:
        return []
    cost = _sanitize(cost)
    try:
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(cost)
        return [(int(r), int(c)) for r, c in zip(rows, cols)]
    except Exception:  # pragma: no cover - scipy failure path
        return greedy_assignment(cost)


def greedy_assignment_device(cost: torch.Tensor, max_cost: float = BIG_COST) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, M) cost -> (row_assign (N,), col_assign (M,)) int32 on its device.

    row_assign[i] is the matched column or -1, col_assign[j] the matched row
    or -1. Each of the min(N, M) rounds takes the first minimum in row-major
    order (``torch.min`` returns the first, as ``jnp.argmin`` does); a pick
    within ``max_cost`` closes its row and column, any other pick closes its
    own cell. ``max_cost`` is finite: a closed cell (inf) is never taken. No
    value goes to the host, so a loop of calls never waits on the device.
    """
    N, M = cost.shape
    dev = cost.device
    if N == 0 or M == 0:
        return (torch.full((N,), -1, dtype=torch.int32, device=dev),
                torch.full((M,), -1, dtype=torch.int32, device=dev))
    c = torch.where(torch.isfinite(cost), cost, torch.full_like(cost, BIG_COST)).float()
    cell = (torch.arange(N, device=dev)[:, None] * M + torch.arange(M, device=dev)[None, :])
    assigned = torch.zeros((N, M), dtype=torch.bool, device=dev)
    for _ in range(min(N, M)):
        val, flat = c.view(-1).min(dim=0)
        pick = cell == flat
        take = pick & (val <= max_cost)
        assigned |= take
        c = c.masked_fill(pick | take.any(1, keepdim=True) | take.any(0, keepdim=True), float("inf"))
    rows = torch.where(assigned.any(1), assigned.to(torch.int32).argmax(1), -1).to(torch.int32)
    cols = torch.where(assigned.any(0), assigned.to(torch.int32).argmax(0), -1).to(torch.int32)
    return rows, cols


class HungarianAlgorithm:
    """The reference's facade: ``solve`` is the exact LAP."""

    def solve(self, cost_matrix: np.ndarray) -> list[tuple[int, int]]:
        return solve_lap(np.asarray(cost_matrix))

    def _greedy_assignment(self, cost_matrix: np.ndarray) -> list[tuple[int, int]]:
        return greedy_assignment(np.asarray(cost_matrix))
