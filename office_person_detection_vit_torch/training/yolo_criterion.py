"""YOLOv8 training loss and steps (``models/yolo.py``).

Mirrors ``office_person_detection_vit_tpu/training/yolo_criterion.py``:
``YOLOCriterionConfig`` (:35, ultralytics' gains box 7.5, cls 0.5, dfl 1.5,
``reg_max`` 16, strides 8/16/32), ``ciou`` (:51), ``dfl_loss`` (:82),
``_level_loss`` (:98), ``yolo_loss`` (:169), ``make_yolo_train_step``
(:212) and ``make_yolo_sharded_train_step`` (:243).

The losses are YOLOv8's three: BCE on the class logits, CIoU on the
DFL-decoded boxes, and the distribution focal loss on each side's distance
distribution (cross-entropy against the two integer bins around the true
distance). The assignment is the single-shot criterion's centre sampling
with per-level size ranges (``ssd_criterion.assign_targets``), the JAX
package's documented simplification of ultralytics' task-aligned assigner,
ported as it is. The loss is normalised by the batch's total positive count
(JAX :184); the data-parallel step all-reduces that count first.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..models.yolo import dfl_expectation
from .ssd_criterion import _bce, assign_targets, gather_targets, gt_xyxy, make_single_shot_step


@dataclass(frozen=True)
class YOLOCriterionConfig:
    strides: tuple[int, ...] = (8, 16, 32)
    reg_max: int = 16
    center_radius: float = 1.5
    # ultralytics' default loss gains
    w_box: float = 7.5
    w_cls: float = 0.5
    w_dfl: float = 1.5

    def size_ranges(self) -> list[tuple[float, float]]:
        bounds = [8.0 * s for s in self.strides[:-1]]
        return list(zip([0.0] + bounds, bounds + [float("inf")]))


def ciou(px: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """Complete IoU (Zheng et al. 2020) of xyxy boxes, elementwise over
    broadcastable leading dims; in [-1.5, 1]. The aspect term's weight alpha
    carries no gradient (JAX ``stop_gradient``)."""
    px0, py0, px1, py1 = px.unbind(-1)
    gx0, gy0, gx1, gy1 = gx.unbind(-1)
    inter = ((torch.minimum(px1, gx1) - torch.maximum(px0, gx0)).clamp(min=0)
             * (torch.minimum(py1, gy1) - torch.maximum(py0, gy0)).clamp(min=0))
    pw, ph = (px1 - px0).clamp(min=0), (py1 - py0).clamp(min=0)
    gw, gh = (gx1 - gx0).clamp(min=0), (gy1 - gy0).clamp(min=0)
    union = pw * ph + gw * gh - inter
    iou = inter / union.clamp(min=1e-9)
    # the enclosing box's squared diagonal and the centres' squared distance
    cw = torch.maximum(px1, gx1) - torch.minimum(px0, gx0)
    chh = torch.maximum(py1, gy1) - torch.minimum(py0, gy0)
    c2 = cw * cw + chh * chh + 1e-9
    rho2 = ((px0 + px1 - gx0 - gx1) ** 2 + (py0 + py1 - gy0 - gy1) ** 2) / 4.0
    # aspect-ratio consistency
    v = (4.0 / math.pi**2) * (torch.atan(gw / gh.clamp(min=1e-9)) - torch.atan(pw / ph.clamp(min=1e-9))) ** 2
    alpha = (v / (1.0 - iou + v).clamp(min=1e-9)).detach()
    return iou - rho2 / c2 - alpha * v


def dfl_loss(box_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss of one side set: ``box_dist`` (..., 4,
    reg_max) logits, ``target`` (..., 4) distances in cells, clipped to
    [0, reg_max - 1 - eps] -> (..., 4)."""
    logp = torch.log_softmax(box_dist, dim=-1)
    tl = torch.floor(target).long()
    tr = tl + 1
    wl = tr.float() - target
    wr = target - tl.float()
    reg_max = box_dist.shape[-1]

    def pick(idx):
        return torch.gather(logp, -1, idx.clamp(0, reg_max - 1)[..., None])[..., 0]

    return -(wl * pick(tl) + wr * pick(tr))


def _level_loss(level: dict, tgt_labels, tgt_boxes, tgt_valid, input_hw, stride: int, size_range,
                config: YOLOCriterionConfig, content_hw=None):
    """Unnormalised (cls, box, dfl) sums and the positive count of one level."""
    cls, box_dist = level["class_logits"], level["box_dist"]  # (B, fh, fw, C), (B, fh, fw, 4 R)
    B, fh, fw, C = cls.shape
    ih, iw = content_hw if content_hw is not None else input_hw
    R = config.reg_max
    pos, box_idx = assign_targets(tgt_boxes, tgt_valid, (fh, fw), input_hw, config.center_radius, stride,
                                  size_range, content_hw)
    posf = pos.float()
    num_pos = posf.sum()

    labels, gb = gather_targets(tgt_labels, tgt_boxes, box_idx)
    onehot = F.one_hot((labels - 1).clamp(0, C - 1), C).float() * posf[..., None]
    sum_cls = _bce(cls, onehot).sum()

    g = gt_xyxy(gb, ih, iw)
    gx0, gy0, gx1, gy1 = g.unbind(-1)
    ltrb = dfl_expectation(box_dist, R)  # (B, fh, fw, 4) in cells
    dev = cls.device
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + 0.5)[None, None, :]
    cy = (torch.arange(fh, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
    pxyxy = torch.stack([(cx - ltrb[..., 0]) * stride, (cy - ltrb[..., 1]) * stride,
                         (cx + ltrb[..., 2]) * stride, (cy + ltrb[..., 3]) * stride], dim=-1)
    sum_box = ((1.0 - ciou(pxyxy, g)) * posf).sum()

    # DFL targets: the true anchor-to-side distances in cells
    tgt_ltrb = torch.stack([cx - gx0 / stride, cy - gy0 / stride, gx1 / stride - cx, gy1 / stride - cy], dim=-1)
    tgt_ltrb = tgt_ltrb.clamp(0.0, R - 1 - 0.01)
    per_side = dfl_loss(box_dist.reshape(B, fh, fw, 4, R), tgt_ltrb)
    sum_dfl = (per_side.mean(-1) * posf).sum()
    return sum_cls, sum_box, sum_dfl, num_pos


def loss_sums(outputs: dict, tgt_labels, tgt_boxes, tgt_valid, input_hw, config: YOLOCriterionConfig,
              content_hw=None) -> torch.Tensor:
    """(cls, box, dfl, num_pos) summed over the levels, unnormalised (4,)."""
    sums = [torch.stack(_level_loss(level, tgt_labels, tgt_boxes, tgt_valid, input_hw, stride, size_range,
                                    config, content_hw))
            for level, stride, size_range in zip(outputs["levels"], config.strides, config.size_ranges())]
    return torch.stack(sums).sum(0)


def normalise(sums: torch.Tensor, config: YOLOCriterionConfig) -> tuple[torch.Tensor, dict]:
    """Loss sums (:func:`loss_sums`) -> (total, metrics), each divided by
    max(num_pos, 1) and weighted by the gains."""
    num_pos = sums[3].clamp(min=1.0)
    loss_cls, loss_box, loss_dfl = sums[0] / num_pos, sums[1] / num_pos, sums[2] / num_pos
    total = config.w_cls * loss_cls + config.w_box * loss_box + config.w_dfl * loss_dfl
    return total, {"loss": total, "loss_cls": loss_cls, "loss_box": loss_box, "loss_dfl": loss_dfl,
                   "num_pos": num_pos}


def yolo_loss(outputs: dict, tgt_labels, tgt_boxes, tgt_valid, input_hw: tuple[int, int],
              config: YOLOCriterionConfig = YOLOCriterionConfig(),
              content_hw: tuple[int, int] | None = None) -> tuple[torch.Tensor, dict]:
    """``outputs``: ``{"levels": [{box_dist, class_logits}, ...]}``;
    ``tgt_labels`` (B, T) 1-based ids, ``tgt_boxes`` (B, T, 4) cxcywh
    normalised, ``tgt_valid`` (B, T) -> (total, metrics)."""
    return normalise(loss_sums(outputs, tgt_labels, tgt_boxes, tgt_valid, input_hw, config, content_hw), config)


def _config(model, config):
    return config or YOLOCriterionConfig(strides=model.config.strides, reg_max=model.config.reg_max)


def make_yolo_train_step(model, tx, input_hw: tuple[int, int], config: YOLOCriterionConfig | None = None,
                         ema_decay=None, augment=None, content_hw: tuple[int, int] | None = None):
    """(state, batch, generator) -> (state, metrics), in place: the DETR
    step's contract with the batch's ``pixels``, ``labels``, ``boxes`` and
    ``valid`` (no pixel mask), optional EMA and on-device augmentation.
    ``content_hw``: the letterboxed valid-content extent the GT boxes are
    normalised to; pass it whenever frames are letterboxed."""
    config = _config(model, config)
    return make_single_shot_step(
        model, tx, lambda out, l, b, v: loss_sums(out, l, b, v, input_hw, config, content_hw),
        lambda sums: normalise(sums, config), ema_decay, augment)


def make_yolo_sharded_train_step(model, tx, mesh, input_hw: tuple[int, int],
                                 config: YOLOCriterionConfig | None = None, ema_decay=None, augment=None,
                                 content_hw: tuple[int, int] | None = None):
    """The same step, data-parallel over ``mesh`` (``parallel.mesh.Mesh``;
    JAX's takes a params template for its shardings, which the port's
    ranks do not need): no tensor-parallel rule matches a convolution, so
    every rank keeps the whole model (the ranks of a model group compute
    the same), takes its data slice of the batch (after the whole batch's
    augmentation), and the positive count and the gradients are
    all-reduced over the data ranks. Every rank is given the whole batch."""
    config = _config(model, config)
    return make_single_shot_step(
        model, tx, lambda out, l, b, v: loss_sums(out, l, b, v, input_hw, config, content_hw),
        lambda sums: normalise(sums, config), ema_decay, augment, reduce=mesh.data_group())
