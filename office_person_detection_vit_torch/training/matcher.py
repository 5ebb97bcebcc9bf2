"""Bipartite matcher for DETR training: the auction algorithm.

Mirrors ``office_person_detection_vit_tpu/training/matcher.py``. Unassigned
targets bid for their best query in a Jacobi price war (Bertsekas 1988); the
result is within T*eps of the optimal matching. Every trip is the JAX body's
arithmetic in float32 with its ``argmax`` tie rule (the first maximum), so the
port returns the JAX index vector.

Two changes cut the launches and keep the result:

- :func:`auction_assignment` takes a batch of independent problems
  (N, T, Q): the train step stacks every decoder layer's problems of every
  image into one call;
- it stops once every row of every problem is assigned, checked every
  ``check_every`` trips (one host sync each). From then on a trip changes
  nothing: no row is unassigned, so no column is won. ``check_every=0``
  runs all ``num_iters`` trips, as the JAX loop does.

JAX's ``mode="drop"`` scatters have no torch counterpart: the port scatters
into a canvas with one spare slot and drops that slot.

Matching cost (DETR paper, arXiv:2005.12872 section 3.1):
C = w_class * class cost + w_bbox * L1(cxcywh) + w_giou * (-GIoU).
"""

from __future__ import annotations

import torch

from ..ops.boxes import cxcywh_to_xyxy, generalized_iou_xyxy

NEG_INF = -1e9


@torch.no_grad()
def auction_assignment(benefit: torch.Tensor, num_iters: int = 200, eps: float = 1e-3,
                       check_every: int = 8) -> torch.Tensor:
    """Maximize total benefit assigning each row a distinct column.

    benefit (T, Q) or (N, T, Q), T <= Q -> (T,) or (N, T) int64: the column of
    each row. Rows the price war leaves unassigned (only when ``num_iters`` is
    too small) are patched greedily at the end, row by row, as in JAX.
    """
    single = benefit.dim() == 2
    if single:
        benefit = benefit[None]
    N, T, Q = benefit.shape
    dev = benefit.device
    n_idx = torch.arange(N, device=dev)[:, None]
    cols = torch.arange(Q, device=dev)
    price = torch.zeros((N, Q), dtype=benefit.dtype, device=dev)
    owner = torch.full((N, Q), -1, dtype=torch.int64, device=dev)
    col_of = torch.full((N, T + 1), -1, dtype=torch.int64, device=dev)  # slot T: the drop slot
    neg = torch.tensor(NEG_INF, dtype=benefit.dtype, device=dev)

    for trip in range(num_iters):
        if check_every and trip % check_every == 0 and bool((col_of[:, :T] >= 0).all()):
            break
        unassigned = col_of[:, :T] < 0  # (N, T)
        value = benefit - price[:, None, :]  # (N, T, Q)
        best_col = value.argmax(dim=2)  # the first maximum, as jnp.argmax
        v1 = value.amax(dim=2)
        v2 = value.scatter(2, best_col[..., None], NEG_INF).amax(dim=2)
        bid = v1 - v2 + eps  # (N, T)

        # Per-column best bid among unassigned rows targeting it.
        targets = unassigned[..., None] & (best_col[..., None] == cols)  # (N, T, Q)
        contrib = torch.where(targets, bid[..., None], neg)
        col_bid = contrib.amax(dim=1)  # (N, Q)
        col_winner = contrib.argmax(dim=1)  # the first row on ties
        won = col_bid > NEG_INF / 2

        # Evict the previous owners of contested columns, then assign winners.
        evicted = torch.where(won & (owner >= 0), owner, T)
        col_of[n_idx, evicted] = -1
        winner_rows = torch.where(won, col_winner, T)
        col_of[n_idx, winner_rows] = cols.expand(N, Q)
        owner = torch.where(won, col_winner, owner)
        price = torch.where(won, price + col_bid, price)

    col_of = col_of[:, :T]
    if bool((col_of < 0).any()):  # greedy patch-up of leftover rows
        for i in range(T):
            taken = torch.zeros((N, Q + 1), dtype=torch.bool, device=dev)
            taken[n_idx, torch.where(col_of >= 0, col_of, Q)] = True
            free_value = torch.where(taken[:, :Q], neg, benefit[:, i])
            col_of[:, i] = torch.where(col_of[:, i] < 0, free_value.argmax(dim=1), col_of[:, i])
    return col_of[0] if single else col_of


def matching_cost(logits, pred_boxes, tgt_labels, tgt_boxes, w_class: float = 1.0,
                  w_bbox: float = 5.0, w_giou: float = 2.0, class_cost: str = "ce",
                  focal_alpha: float = 0.25, focal_gamma: float = 2.0) -> torch.Tensor:
    """(..., Q, C+1) logits, (..., Q, 4) cxcywh preds, (..., T) labels,
    (..., T, 4) cxcywh targets -> (..., T, Q) cost."""
    labels = tgt_labels.long()
    if class_cost == "focal":
        # Deformable-DETR matcher cost: positive-minus-negative focal terms
        # at the target class, over the sigmoids of the real classes.
        prob = torch.sigmoid(logits[..., :-1].float())  # (..., Q, C)
        neg = ((1.0 - focal_alpha) * prob ** focal_gamma
               * (-torch.log1p(-prob.clamp(max=1.0 - 1e-8))))
        pos = focal_alpha * (1.0 - prob) ** focal_gamma * (-torch.log(prob.clamp(min=1e-8)))
        per_class = pos - neg
    else:
        per_class = -torch.softmax(logits.float(), dim=-1)  # (..., Q, C+1)
    idx = labels[..., None, :].expand(*per_class.shape[:-1], labels.shape[-1])
    cost_class = torch.gather(per_class, -1, idx).transpose(-1, -2)  # (..., T, Q)
    cost_bbox = (tgt_boxes[..., :, None, :] - pred_boxes[..., None, :, :]).abs().sum(-1)
    giou = generalized_iou_xyxy(cxcywh_to_xyxy(tgt_boxes), cxcywh_to_xyxy(pred_boxes))
    return w_class * cost_class + w_bbox * cost_bbox + w_giou * (-giou)


@torch.no_grad()
def batch_hungarian_match(logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid,
                          num_iters: int = 200, class_cost: str = "ce",
                          focal_alpha: float = 0.25, focal_gamma: float = 2.0,
                          check_every: int = 8) -> torch.Tensor:
    """Matching of every problem in the leading dims: (..., Q, C+1),
    (..., Q, 4), (..., T), (..., T, 4), (..., T) -> (..., T) int64 query per
    target slot. Padded slots (``tgt_valid`` False) get a flat zero cost row,
    so they absorb leftover queries without moving real matches."""
    T, Q = tgt_labels.shape[-1], logits.shape[-2]
    if T > Q:  # infeasible: the price war never ends and the matching is random
        raise ValueError(
            f"hungarian_match needs padded target capacity T <= num_queries "
            f"(got T={T} > Q={Q}); clamp the target capacity (e.g. "
            f"train_detr --max-targets) to the model's query count"
        )
    cost = matching_cost(logits, pred_boxes, tgt_labels, tgt_boxes, class_cost=class_cost,
                         focal_alpha=focal_alpha, focal_gamma=focal_gamma)
    cost = torch.where(tgt_valid[..., None], cost, torch.zeros((), dtype=cost.dtype, device=cost.device))
    lead = cost.shape[:-2]
    match = auction_assignment(-cost.reshape(-1, T, Q), num_iters, check_every=check_every)
    return match.reshape(*lead, T)


def hungarian_match(logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid, num_iters: int = 200,
                    class_cost: str = "ce", focal_alpha: float = 0.25,
                    focal_gamma: float = 2.0) -> torch.Tensor:
    """One image: (Q, C+1), (Q, 4), (T,), (T, 4), (T,) -> (T,) query per slot."""
    return batch_hungarian_match(logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid,
                                 num_iters, class_cost, focal_alpha, focal_gamma)
