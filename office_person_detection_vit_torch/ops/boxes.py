"""Box utilities on tensors.

Mirrors ``office_person_detection_vit_tpu/ops/boxes.py`` (the functions the
detector path, the matcher, the set loss and the trackers use). All take
leading batch dimensions. ``iou_matrix_xywh_np`` is the host numpy form that
the cascade tracker and the MOT metrics use.
"""

from __future__ import annotations

import numpy as np
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


def xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x, y, x + w, y + h], dim=-1)


def center_xywh(boxes_xywh: torch.Tensor) -> torch.Tensor:
    """Box centre (x + w/2, y + h/2) -> (..., 2)."""
    x, y, w, h = boxes_xywh.unbind(-1)
    return torch.stack([x + w / 2, y + h / 2], dim=-1)


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


def iou_matrix_xywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return iou_matrix_xyxy(xywh_to_xyxy(a), xywh_to_xyxy(b))


def iou_matrix_xywh_np(a, b) -> np.ndarray:
    """Host numpy IoU of xywh boxes: (N, 4) x (M, 4) -> (N, M) float32, 0
    where the union is empty (the divide is guarded, not only the select)."""
    a = np.asarray(a, np.float32).reshape(-1, 4)
    b = np.asarray(b, np.float32).reshape(-1, 4)
    ax0, ay0, ax1, ay1 = a[:, 0], a[:, 1], a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx0, by0, bx1, by1 = b[:, 0], b[:, 1], b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    iw = np.maximum(np.minimum(ax1[:, None], bx1[None, :]) - np.maximum(ax0[:, None], bx0[None, :]), 0.0)
    ih = np.maximum(np.minimum(ay1[:, None], by1[None, :]) - np.maximum(ay0[:, None], by0[None, :]), 0.0)
    inter = iw * ih
    area_a = np.maximum(ax1 - ax0, 0.0) * np.maximum(ay1 - ay0, 0.0)
    area_b = np.maximum(bx1 - bx0, 0.0) * np.maximum(by1 - by0, 0.0)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0).astype(np.float32)


def generalized_iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU: a (..., N, 4), b (..., M, 4) xyxy -> (..., N, M); the
    DETR matcher's and set loss's box term."""
    iou = iou_matrix_xyxy(a, b)
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    lt = torch.minimum(a[..., :2], b[..., :2])
    rb = torch.maximum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    enclose = wh[..., 0] * wh[..., 1]
    inter_wh = (torch.minimum(a[..., 2:], b[..., 2:]) - torch.maximum(a[..., :2], b[..., :2])).clamp(min=0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = box_area_xyxy(a) + box_area_xyxy(b) - inter
    return iou - torch.where(enclose > 0, (enclose - union) / enclose, torch.zeros_like(enclose))


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
