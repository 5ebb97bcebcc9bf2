"""FCOS-style training loss and step of the single-shot detector
(``models/single_shot.py``).

Mirrors ``office_person_detection_vit_tpu/training/ssd_criterion.py``:
``SSDCriterionConfig`` (:25), ``_bce`` (:41), ``assign_targets`` (:47),
``_level_loss`` (:95), ``ssd_loss`` (:161) and ``make_ssd_train_step``
(:199).

Anchor-free centre-sampling assignment, vectorised over the batch:

- a grid cell is positive for a GT box when the cell centre lies inside the
  box's central region (``center_radius * stride``), inside the box, and the
  box's longer side belongs on the level (FCOS size ranges);
- overlapping GTs resolve to the smallest-area box;
- losses: BCE on objectness over all cells (positives 1), BCE on the class
  scores and the IoU loss on the (l, t, r, b) regression over the positive
  cells, normalised by the batch's total positive count.

Under data parallelism (``parallel/``) a rank sees a slice of the batch:
``loss_sums`` gives its unnormalised sums, and the sharded step divides them
by the all-reduced count (:func:`make_single_shot_step`), so the loss and
the summed gradients are the whole batch's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class SSDCriterionConfig:
    strides: tuple[int, ...] = (8, 16, 32)
    center_radius: float = 1.5
    w_obj: float = 1.0
    w_cls: float = 1.0
    w_iou: float = 2.0

    def size_ranges(self) -> list[tuple[float, float]]:
        """FCOS per-level gates on max(w, h) in pixels: the finest level
        takes small boxes, the coarsest the rest."""
        bounds = [8.0 * s for s in self.strides[:-1]]
        return list(zip([0.0] + bounds, bounds + [float("inf")]))


def _bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def assign_targets(tgt_boxes: torch.Tensor, tgt_valid: torch.Tensor, grid_hw: tuple[int, int],
                   input_hw: tuple[int, int], center_radius: float, stride: int,
                   size_range: tuple[float, float] = (0.0, float("inf")),
                   content_hw: tuple[int, int] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cell assignment: ``tgt_boxes`` (..., T, 4) cxcywh normalised,
    ``tgt_valid`` (..., T) -> (pos (..., fh, fw) bool, box_idx (..., fh, fw)
    int64, the index of the assigned GT). Leading dims are a batch (JAX
    vmaps the one-image function).

    ``content_hw`` is the letterboxed valid-content extent: normalised GT
    boxes map to ``content_hw`` pixels, while the anchor grid spans the full
    ``input_hw`` canvas. Defaults to ``input_hw``."""
    fh, fw = grid_hw
    ih, iw = content_hw if content_hw is not None else input_hw
    dev = tgt_boxes.device
    cy = (torch.arange(fh, dtype=torch.float32, device=dev) + 0.5) * stride
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + 0.5) * stride
    tgt_boxes = tgt_boxes.float()
    gcx, gcy = tgt_boxes[..., 0] * iw, tgt_boxes[..., 1] * ih  # (..., T)
    gw, gh = tgt_boxes[..., 2] * iw, tgt_boxes[..., 3] * ih

    # (..., T, fh, fw): centre region AND inside the box AND size on this level
    dx = (cx - gcx[..., None, None]).abs()  # (..., T, 1, fw)
    dy = (cy[:, None] - gcy[..., None, None]).abs()  # (..., T, fh, 1)
    in_center = (dx <= center_radius * stride) & (dy <= center_radius * stride)
    in_box = (dx <= gw[..., None, None] / 2) & (dy <= gh[..., None, None] / 2)
    max_side = torch.maximum(gw, gh)
    lo, hi = size_range
    in_range = (max_side > lo) & (max_side <= hi)
    candidate = in_center & in_box & (tgt_valid.bool() & in_range)[..., None, None]

    inf = torch.tensor(float("inf"), device=dev)
    area = torch.where(tgt_valid.bool(), gw * gh, inf)
    # The smallest-area GT wins a cell (argmin: the first of equal areas).
    cell_area = torch.where(candidate, area[..., None, None], inf)
    box_idx = torch.argmin(cell_area, dim=-3)
    pos = candidate.any(dim=-3)
    return pos, box_idx


def gather_targets(tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor,
                   box_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The assigned label (B, fh, fw) and cxcywh box (B, fh, fw, 4) of each
    cell (JAX ``take_along_axis`` over the flattened grid)."""
    B, fh, fw = box_idx.shape
    flat = box_idx.reshape(B, -1)
    labels = torch.gather(tgt_labels.long(), 1, flat).reshape(B, fh, fw)
    boxes = torch.gather(tgt_boxes.float(), 1, flat[..., None].expand(B, fh * fw, 4)).reshape(B, fh, fw, 4)
    return labels, boxes


def gt_xyxy(gb: torch.Tensor, ih: int, iw: int) -> torch.Tensor:
    """cxcywh normalised (..., 4) -> xyxy in content pixels (..., 4)."""
    return torch.stack([(gb[..., 0] - gb[..., 2] / 2) * iw, (gb[..., 1] - gb[..., 3] / 2) * ih,
                        (gb[..., 0] + gb[..., 2] / 2) * iw, (gb[..., 1] + gb[..., 3] / 2) * ih], dim=-1)


def _level_loss(level: dict, tgt_labels, tgt_boxes, tgt_valid, input_hw, stride: int,
                size_range, config: SSDCriterionConfig, content_hw=None):
    """Unnormalised loss sums and the positive count of one level."""
    obj, cls, ltrb = level["objectness"], level["class_logits"], level["ltrb"]
    B, fh, fw = obj.shape
    C = cls.shape[-1]
    ih, iw = content_hw if content_hw is not None else input_hw
    pos, box_idx = assign_targets(tgt_boxes, tgt_valid, (fh, fw), input_hw, config.center_radius, stride,
                                  size_range, content_hw)
    posf = pos.float()
    num_pos = posf.sum()
    sum_obj = _bce(obj, posf).sum()

    labels, gb = gather_targets(tgt_labels, tgt_boxes, box_idx)
    onehot = F.one_hot((labels - 1).clamp(0, C - 1), C).float()
    sum_cls = (_bce(cls, onehot) * posf[..., None]).sum()

    dev = obj.device
    cy = ((torch.arange(fh, dtype=torch.float32, device=dev) + 0.5) * stride)[:, None]
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + 0.5) * stride
    l, t, r, b = (ltrb[..., i] * stride for i in range(4))
    px0, py0, px1, py1 = cx - l, cy - t, cx + r, cy + b
    g = gt_xyxy(gb, ih, iw)
    gx0, gy0, gx1, gy1 = g.unbind(-1)
    inter = ((torch.minimum(px1, gx1) - torch.maximum(px0, gx0)).clamp(min=0)
             * (torch.minimum(py1, gy1) - torch.maximum(py0, gy0)).clamp(min=0))
    area_p = (px1 - px0).clamp(min=0) * (py1 - py0).clamp(min=0)
    area_g = (gx1 - gx0).clamp(min=0) * (gy1 - gy0).clamp(min=0)
    iou = inter / (area_p + area_g - inter).clamp(min=1e-9)
    sum_iou = ((1.0 - iou) * posf).sum()
    return sum_obj, sum_cls, sum_iou, num_pos


def loss_sums(outputs: dict, tgt_labels, tgt_boxes, tgt_valid, input_hw, config: SSDCriterionConfig,
              content_hw=None) -> torch.Tensor:
    """(obj, cls, iou, num_pos) summed over the levels, unnormalised: a (4,)
    tensor that a data-parallel step all-reduces before :func:`normalise`."""
    sums = [torch.stack(_level_loss(level, tgt_labels, tgt_boxes, tgt_valid, input_hw, stride, size_range,
                                    config, content_hw))
            for level, stride, size_range in zip(outputs["levels"], config.strides, config.size_ranges())]
    return torch.stack(sums).sum(0)


def normalise(sums: torch.Tensor, config: SSDCriterionConfig) -> tuple[torch.Tensor, dict]:
    """Loss sums (:func:`loss_sums`) -> (total, metrics), each sum divided by
    max(num_pos, 1)."""
    num_pos = sums[3].clamp(min=1.0)
    loss_obj, loss_cls, loss_iou = sums[0] / num_pos, sums[1] / num_pos, sums[2] / num_pos
    total = config.w_obj * loss_obj + config.w_cls * loss_cls + config.w_iou * loss_iou
    return total, {"loss": total, "loss_obj": loss_obj, "loss_cls": loss_cls, "loss_iou": loss_iou,
                   "num_pos": num_pos}


def ssd_loss(outputs: dict, tgt_labels, tgt_boxes, tgt_valid, input_hw: tuple[int, int],
             config: SSDCriterionConfig = SSDCriterionConfig(),
             content_hw: tuple[int, int] | None = None) -> tuple[torch.Tensor, dict]:
    """Multi-level FCOS loss, normalised by the batch's total positive count.
    ``content_hw``: the letterboxed valid-content extent the normalised GT
    boxes refer to (default: the whole canvas)."""
    return normalise(loss_sums(outputs, tgt_labels, tgt_boxes, tgt_valid, input_hw, config, content_hw), config)


def make_single_shot_step(model, tx, loss_sums_fn, normalise_fn, ema_decay=None, augment=None, reduce=None):
    """(state, batch, generator) -> (state, metrics), in place, on the port's
    ``TrainState``/``apply_update``: optional on-device augmentation drawn
    from ``generator``, the forward, the loss, the backward, the update and
    the EMA. ``loss_sums_fn`` gives the unnormalised sums with the positive
    count last, ``normalise_fn`` divides them by it.

    ``reduce`` (``parallel.mesh.DataGroup``, the data-parallel step): each
    rank holds a slice of the batch. Its loss is its own sums over the
    global positive count (all-reduced), so the all-reduced sum of the
    ranks' gradients is the whole batch's gradient; the metrics are those
    of the all-reduced sums."""
    from .train_step import apply_update, gradients

    def step(state, batch: dict, generator: torch.Generator, mark=lambda _name: None):
        if augment is not None:
            from .augment import augment_batch

            batch = augment_batch(generator, batch, augment)  # the whole batch's draws
        if reduce is not None:
            batch = reduce.local(batch)
        state.model.train()
        state.model.zero_grad(set_to_none=True)
        out = state.model(batch["pixels"])
        mark("forward")
        sums = loss_sums_fn(out, batch["labels"], batch["boxes"], batch["valid"])
        if reduce is None:
            total, metrics = normalise_fn(sums)
        else:
            global_sums = reduce.all_sum(sums.detach())
            total, _ = normalise_fn(torch.cat([sums[:-1], global_sums[-1:]]))
            _, metrics = normalise_fn(global_sums)
        mark("loss")
        total.backward()
        mark("backward")
        grads = gradients(state.params)
        if reduce is not None:
            reduce.all_sum_(grads)
        apply_update(state, grads, tx, ema_decay)
        mark("optimizer")
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_ssd_train_step(model, tx, input_hw: tuple[int, int], config: SSDCriterionConfig | None = None,
                        ema_decay=None, augment=None, content_hw: tuple[int, int] | None = None):
    """(state, batch, generator) -> (state, metrics) for the single-shot
    detector, the DETR step's contract (``training/train_step.py``) with
    the batch's ``pixels``, ``labels``, ``boxes`` and ``valid`` (no pixel
    mask). ``content_hw``: the letterboxed valid-content extent the GT boxes
    are normalised to; pass it whenever frames are letterboxed."""
    if config is None:
        config = SSDCriterionConfig(strides=model.config.strides)
    return make_single_shot_step(
        model, tx, lambda out, l, b, v: loss_sums(out, l, b, v, input_hw, config, content_hw),
        lambda sums: normalise(sums, config), ema_decay, augment)
