"""Box utilities on tensors.

Mirrors ``office_person_detection_vit_tpu/ops/boxes.py`` (the functions the
detector path uses). All take leading batch dimensions.
"""

from __future__ import annotations

import torch


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([x0, y0, x1 - x0, y1 - y0], dim=-1)


def foot_point_xywh(boxes_xywh: torch.Tensor) -> torch.Tensor:
    """Bottom-center floor-contact point (x + w/2, y + h) -> (..., 2)."""
    x, y, w, h = boxes_xywh.unbind(-1)
    return torch.stack([x + w / 2, y + h], dim=-1)


def box_area_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    return w * h


def iou_matrix_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a (..., N, 4), b (..., M, 4) xyxy -> (..., N, M)."""
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area_xyxy(a) + box_area_xyxy(b) - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms_mask(
    boxes_xyxy: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Greedy NMS as a keep mask: (..., Q, 4), (..., Q) -> (..., Q) bool.

    Candidates are visited in descending score order (a stable sort, so ties
    keep query order, as ``jnp.argsort`` does); a kept candidate suppresses
    every later one whose IoU with it is strictly above the threshold.
    """
    Q = boxes_xyxy.shape[-2]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    key = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.argsort(-key, dim=-1, stable=True)
    boxes_sorted = torch.gather(boxes_xyxy, -2, order[..., None].expand(*order.shape, 4))
    valid_sorted = torch.gather(valid, -1, order)
    iou = iou_matrix_xyxy(boxes_sorted, boxes_sorted)
    idx = torch.arange(Q, device=scores.device)
    keep = valid_sorted.clone()
    for i in range(Q):
        suppress = (iou[..., i, :] > iou_threshold) & (keep[..., i : i + 1] & valid_sorted[..., i : i + 1])
        keep &= ~(suppress & (idx > i))
    out = torch.zeros_like(keep)
    return out.scatter(-1, order, keep)
