"""DETR outputs -> fixed-shape ``DetectionBatch`` (host numpy).

Mirrors ``office_person_detection_vit_tpu/models/postprocess.py``: softmax
over all classes then drop the no-object column (or a per-class sigmoid for
focal heads), per-query max/argmax (first of ties), person filter, then the
``>=`` confidence threshold, optional greedy NMS per frame, and the foot point.
"""

from __future__ import annotations

import torch

from ..core.dto import DetectionBatch
from ..ops import boxes as box_ops


def postprocess_detr(
    logits: torch.Tensor,  # (F, Q, C+1)
    pred_boxes: torch.Tensor,  # (F, Q, 4) sigmoid cxcywh, normalized
    orig_size,  # (width, height) of the original frames
    confidence_threshold: float = 0.5,
    person_class_id: int = 1,
    score_mode: str = "softmax",
    nms_iou: float | None = None,
    host: bool = True,
) -> DetectionBatch | dict:
    """``orig_size`` and ``confidence_threshold`` may be tensors (an exported
    program's inputs). ``host=False``: a dict of the four device tensors
    instead of the host ``DetectionBatch``."""
    if score_mode == "sigmoid":
        probs = torch.sigmoid(logits[..., :-1])
    else:
        probs = torch.softmax(logits, dim=-1)[..., :-1]
    scores, labels = probs.max(dim=-1)

    scale = torch.as_tensor(orig_size, dtype=torch.float32, device=logits.device).repeat(2)  # (w, h, w, h)
    boxes_xyxy = box_ops.cxcywh_to_xyxy(pred_boxes) * scale
    boxes_xywh = box_ops.xyxy_to_xywh(boxes_xyxy)

    valid = (labels == person_class_id) & (scores >= confidence_threshold)
    if nms_iou is not None:
        valid = valid & box_ops.nms_mask(boxes_xyxy, scores, nms_iou, valid)
    foot = box_ops.foot_point_xywh(boxes_xywh)
    out = {"boxes_xywh": boxes_xywh, "scores": scores, "valid": valid, "foot": foot}
    return DetectionBatch(**{k: v.cpu().numpy() for k, v in out.items()}) if host else out


def person_scores(logits: torch.Tensor, person_class_id: int = 1,
                  score_mode: str = "softmax") -> torch.Tensor:
    """(F, Q, C+1) -> (F, Q) probability of the person class."""
    if score_mode == "sigmoid":
        return torch.sigmoid(logits[..., person_class_id])
    return torch.softmax(logits, dim=-1)[..., person_class_id]
