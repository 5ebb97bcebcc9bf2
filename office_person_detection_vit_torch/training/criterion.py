"""DETR set criterion: Hungarian-matched losses.

Mirrors ``office_person_detection_vit_tpu/training/criterion.py`` (DETR,
arXiv:2005.12872 section 3.1):

- classification over every query, matched queries taking their target
  label and the rest "no-object" (the last class): softmax cross-entropy
  with the no-object term weighted ``eos_coef`` (``ce``), or the
  Deformable-DETR per-class sigmoid focal loss (``focal``);
- L1 and GIoU box losses on matched pairs, normalized by the number of
  target boxes.

Targets are fixed-shape: (B, T) labels, (B, T, 4) cxcywh boxes and (B, T)
valid, padded. :func:`detr_loss` takes a precomputed ``match`` so that the
train step can match every decoder layer in one batched auction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.boxes import cxcywh_to_xyxy, generalized_iou_xyxy
from .matcher import batch_hungarian_match


@dataclass(frozen=True)
class CriterionConfig:
    num_classes: int = 91  # real classes; no-object index = num_classes
    eos_coef: float = 0.1
    w_class: float = 1.0
    w_bbox: float = 5.0
    w_giou: float = 2.0
    matcher_iters: int = 200
    #: "ce" (DETR softmax cross-entropy, eos down-weighted) or "focal"
    #: (Deformable-DETR per-class sigmoid focal loss).
    class_loss: str = "ce"
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    #: Weight of the dense encoder-token objectness loss (models with
    #: ``enc_objectness``).
    w_enc_obj: float = 2.0


def match(logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid,
          config: CriterionConfig = CriterionConfig()) -> torch.Tensor:
    """Query index per target slot for every problem in the leading dims
    (no gradient): (..., B, Q, C+1) -> (..., B, T)."""
    return batch_hungarian_match(
        logits.detach().float(), pred_boxes.detach().float(), tgt_labels, tgt_boxes, tgt_valid,
        config.matcher_iters, config.class_loss, config.focal_alpha, config.focal_gamma,
    )


def _focal(logits, target, alpha, gamma):
    bce = -(target * F.logsigmoid(logits) + (1.0 - target) * F.logsigmoid(-logits))
    p = torch.sigmoid(logits)
    p_t = p * target + (1.0 - p) * (1.0 - target)
    a_t = alpha * target + (1.0 - alpha) * (1.0 - target)
    return a_t * (1.0 - p_t) ** gamma * bce


def detr_loss(logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid,
              config: CriterionConfig = CriterionConfig(),
              match_idx: torch.Tensor | None = None,
              total_of=None) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(B, Q, C+1) logits, (B, Q, 4) cxcywh in [0, 1], (B, T) labels,
    (B, T, 4) boxes, (B, T) valid -> total weighted loss and its components.
    ``match_idx`` (B, T): the matching, when already made. ``total_of``:
    maps a denominator (the box count, the class weights' sum) of this
    slice of the batch to the whole batch's (the data-parallel step's
    all-reduce); the sums over the ranks of the losses are then the whole
    batch's."""
    if total_of is None:
        total_of = lambda t: t  # noqa: E731
    B, Q, _ = logits.shape
    logits = logits.float()
    pred_boxes = pred_boxes.float()
    if match_idx is None:
        match_idx = match(logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid, config)

    no_object = config.num_classes
    labels = tgt_labels.long()
    # Matched labels onto the (B, Q) canvas; padded slots go to the spare
    # column Q, which is dropped (JAX: mode="drop").
    classes = torch.full((B, Q + 1), no_object, dtype=torch.int64, device=logits.device)
    scatter_q = torch.where(tgt_valid, match_idx, Q)
    classes.scatter_(1, scatter_q, labels)
    classes = classes[:, :Q]
    safe_q = torch.where(tgt_valid, match_idx, 0)  # box gathers only
    validf = tgt_valid.float()
    num_boxes = total_of(validf.sum()).clamp(min=1.0)

    if config.class_loss == "focal":
        cls_logits = logits[..., :no_object]
        onehot = F.one_hot(classes, no_object + 1)[..., :no_object].float()
        focal = _focal(cls_logits, onehot, config.focal_alpha, config.focal_gamma)
        loss_class = focal.sum() / num_boxes
    else:
        log_probs = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(log_probs, -1, classes[..., None])[..., 0]
        weights = torch.where(classes == no_object, config.eos_coef, 1.0)
        loss_class = (nll * weights).sum() / total_of(weights.sum()).clamp(min=1.0)

    matched = torch.gather(pred_boxes, 1, safe_q[..., None].expand(B, safe_q.shape[1], 4))
    l1 = (matched - tgt_boxes).abs().sum(-1)
    loss_bbox = (l1 * validf).sum() / num_boxes
    giou = torch.diagonal(
        generalized_iou_xyxy(cxcywh_to_xyxy(tgt_boxes), cxcywh_to_xyxy(matched)), dim1=-2, dim2=-1)
    loss_giou = ((1.0 - giou) * validf).sum() / num_boxes

    total = config.w_class * loss_class + config.w_bbox * loss_bbox + config.w_giou * loss_giou
    with torch.no_grad():  # cardinality error: a diagnostic, not a gradient path
        if config.class_loss == "focal":
            fired = torch.sigmoid(logits[..., :no_object]).amax(-1) > 0.5
        else:
            fired = logits.argmax(-1) != no_object
        card_err = (fired.float().sum(1) - validf.sum(1)).abs().mean()
    return total, {
        "loss": total,
        "loss_class": loss_class,
        "loss_bbox": loss_bbox,
        "loss_giou": loss_giou,
        "cardinality_error": card_err,
    }


def encoder_objectness_loss(enc_logits, feature_mask, tgt_boxes, tgt_valid,
                            config: CriterionConfig = CriterionConfig(), total_of=None) -> torch.Tensor:
    """Dense token objectness: sigmoid focal loss against "a valid target box
    covers this token's center", letterbox tokens masked out, normalized by
    the number of boxes. Token centers of the padded grid are mapped into the
    content area by each image's fraction of real rows and columns."""
    B, fh, fw = feature_mask.shape
    maskf = feature_mask.float()
    frac_y = (maskf.amax(dim=2).sum(1) / fh).clamp(min=1e-6)  # (B,)
    frac_x = (maskf.amax(dim=1).sum(1) / fw).clamp(min=1e-6)
    dev = enc_logits.device
    cy = (torch.arange(fh, dtype=torch.float32, device=dev) + 0.5) / fh
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + 0.5) / fw
    ty = cy[None, :] / frac_y[:, None]  # (B, fh)
    tx = cx[None, :] / frac_x[:, None]

    x0 = tgt_boxes[..., 0] - tgt_boxes[..., 2] / 2  # (B, T)
    x1 = tgt_boxes[..., 0] + tgt_boxes[..., 2] / 2
    y0 = tgt_boxes[..., 1] - tgt_boxes[..., 3] / 2
    y1 = tgt_boxes[..., 1] + tgt_boxes[..., 3] / 2
    in_y = (ty[:, None, :] >= y0[..., None]) & (ty[:, None, :] <= y1[..., None])  # (B, T, fh)
    in_x = (tx[:, None, :] >= x0[..., None]) & (tx[:, None, :] <= x1[..., None])  # (B, T, fw)
    covered = in_y[..., :, None] & in_x[..., None, :] & tgt_valid[..., None, None]
    target = covered.any(dim=1).reshape(B, fh * fw).float()

    focal = _focal(enc_logits.float(), target, config.focal_alpha, config.focal_gamma)
    focal = focal * maskf.reshape(B, fh * fw)
    count = tgt_valid.float().sum()
    return focal.sum() / (count if total_of is None else total_of(count)).clamp(min=1.0)


def pack_targets(per_image_boxes: list[Any], per_image_labels: list[Any], capacity: int,
                 device: torch.device | str = "cpu") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ragged host targets -> fixed-shape (labels int32, boxes, valid) tensors."""
    from .data import pack_targets_np

    labels, boxes, valid = pack_targets_np(per_image_boxes, per_image_labels, capacity)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (labels, boxes, valid))
