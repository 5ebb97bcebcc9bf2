"""DETR training step on one device.

Mirrors the single-chip part of
``office_person_detection_vit_tpu/training/train_step.py``: forward (with deep
supervision over the decoder layers) -> Hungarian matching -> set losses ->
backward -> AdamW with the DETR recipe, and ``make_sharded_train_step``
(JAX :313) over a (data, model) grid of ranks (``parallel/``).

The optimizer is a plain loop over the parameters (``torch._foreach_*``) that
computes what the JAX package's optax chain does:

- ``optax.clip_by_global_norm``: scale by ``max_norm / g_norm`` only when
  ``g_norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` would add 1e-6 to
  the norm and scale always);
- ``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8): every parameter decayed,
  biases and norms too, in two learning-rate groups split on the path key
  ``backbone``;
- ``optax.MultiSteps``: the mean of ``accum_steps`` micro-batch gradients,
  applied on the last one; the schedules count applied updates;
- the EMA advances only on applied updates.

The parameters are the model's, in the order ``jax.tree_util`` flattens the
Flax params (``models/weights.py::flax_param_map``), one tensor per leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..models.detr import DETR
from ..models.weights import flax_param_map
from .criterion import CriterionConfig, detr_loss, encoder_objectness_loss, match

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    def sched(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) + end
    return sched


def _join(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    def sched(step: int) -> float:
        out = schedules[0](step)
        for boundary, s in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = s(step - boundary)
        return out
    return sched


def _cosine(init: float, decay_steps: int) -> Schedule:
    def sched(count: int) -> float:
        c = min(count, decay_steps)
        return init * (0.5 * (1 + math.cos(math.pi * c / decay_steps)))
    return sched


def _piecewise(init: float, boundaries_and_scales: dict[int, float]) -> Schedule:
    def sched(count: int) -> float:
        v = init
        for threshold, scale in sorted(boundaries_and_scales.items()):
            if count >= threshold:
                v = v * scale
        return v
    return sched


def make_schedule(learning_rate: float, schedule: str | None = None,
                  total_steps: int | None = None, warmup_steps: int = 0,
                  drop_at: int | None = None, drop_factor: float = 0.1) -> Schedule:
    """Learning rate of the n-th applied update, as optax's schedules give it.

    - ``None`` / ``"none"`` / ``"constant"``: constant, after an optional
      linear warmup;
    - ``"cosine"``: ``warmup_cosine_decay_schedule`` (linear warmup, cosine
      decay to 0 over ``total_steps``);
    - ``"step"``: ``piecewise_constant_schedule`` with a ``drop_factor`` drop
      at global step ``drop_at``, joined after the warmup.
    """
    if schedule == "cosine":
        if total_steps is None:
            raise ValueError("cosine schedule requires total_steps")
        warm = max(1, warmup_steps)
        decay = max(total_steps, warmup_steps + 1)
        init = 0.0 if warmup_steps else learning_rate
        return _join([_linear(init, learning_rate, warm), _cosine(learning_rate, decay - warm)], [warm])
    if schedule == "step":
        if drop_at is None:
            raise ValueError("step schedule requires drop_at")
        if warmup_steps and drop_at <= warmup_steps:
            raise ValueError("drop_at must exceed warmup_steps")
        base = _piecewise(learning_rate, {int(drop_at) - warmup_steps: drop_factor})
    elif schedule in (None, "none", "constant"):
        base = lambda _count: learning_rate  # noqa: E731
    else:
        raise ValueError(f"unknown schedule: {schedule}")
    if warmup_steps:
        return _join([_linear(0.0, learning_rate, warmup_steps), base], [warmup_steps])
    return base


@dataclasses.dataclass
class OptState:
    count: int  # applied updates (the inner optax count)
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    mini_step: int = 0
    acc: list[torch.Tensor] | None = None  # mean gradient of this update's micro-steps


@dataclasses.dataclass
class AdamW:
    """The JAX ``make_optimizer`` chain (see module doc)."""

    lr: Schedule
    backbone_lr: Schedule
    weight_decay: float = 1e-4
    max_grad_norm: float = 0.1
    accum_steps: int = 1
    #: Whether optax would see a schedule (a callable learning rate, whose
    #: ``scale_by_schedule`` keeps a count in the optimizer state) rather
    #: than a constant: the layout of a JAX train state depends on it.
    scheduled: bool = False

    def init(self, params: list[torch.Tensor]) -> OptState:
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        return OptState(0, zeros(), zeros(), 0, zeros() if self.accum_steps > 1 else None)

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: OptState, params: list[torch.Tensor],
               backbone: list[bool], norm_fn: Callable | None = None) -> bool:
        """Take one micro-step in place; True when the update was applied.
        ``norm_fn``: the gradients' global norm where this rank holds parts of
        some (tensor parallelism); by default the norm of ``grads``."""
        if self.accum_steps > 1:
            diff = torch._foreach_sub(grads, state.acc)
            torch._foreach_div_(diff, float(state.mini_step + 1))
            torch._foreach_add_(state.acc, diff)
            if state.mini_step < self.accum_steps - 1:
                state.mini_step += 1
                return False
            grads = [a.clone() for a in state.acc]
            torch._foreach_zero_(state.acc)
            state.mini_step = 0

        # clip_by_global_norm: t unchanged when g_norm < max_norm, else
        # (t / g_norm) * max_norm (one host sync a step).
        g_norm = norm_fn(grads) if norm_fn is not None else torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        if not bool(g_norm < self.max_grad_norm):
            grads = torch._foreach_div(grads, g_norm)
            torch._foreach_mul_(grads, self.max_grad_norm)

        # scale_by_adam
        count_inc = state.count + 1
        torch._foreach_mul_(state.mu, B1)
        torch._foreach_add_(state.mu, grads, alpha=1 - B1)
        torch._foreach_mul_(state.nu, B2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1 - B2)
        bc1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(count_inc))
        bc2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(count_inc))
        mu_hat = torch._foreach_div(state.mu, bc1)
        denom = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        upd = torch._foreach_div(mu_hat, denom)
        # add_decayed_weights, then scale_by_learning_rate at the count
        # before this update (scale_by_schedule).
        torch._foreach_add_(upd, params, alpha=self.weight_decay)
        for is_bb, lr in ((False, self.lr(state.count)), (True, self.backbone_lr(state.count))):
            group = [i for i, b in enumerate(backbone) if b == is_bb]
            if group:
                step = [upd[i] for i in group]
                torch._foreach_mul_(step, -lr)
                torch._foreach_add_([params[i] for i in group], step)
        state.count = count_inc
        return True


def make_optimizer(learning_rate: float = 1e-4, backbone_lr: float = 1e-5, weight_decay: float = 1e-4,
                   max_grad_norm: float = 0.1, schedule: str | None = None,
                   total_steps: int | None = None, warmup_steps: int = 0, drop_at: int | None = None,
                   drop_factor: float = 0.1, accum_steps: int = 1) -> AdamW:
    """AdamW with the DETR recipe: a lower backbone LR, gradient clipping.

    Schedule counts are in micro-steps, the steps the training loop takes;
    they are converted to applied updates here, as in the JAX package.
    """

    def applied(n):
        return None if n is None else max(1, round(n / accum_steps))

    kw = dict(schedule=schedule, total_steps=applied(total_steps),
              warmup_steps=applied(warmup_steps) if warmup_steps else 0,
              drop_at=applied(drop_at), drop_factor=drop_factor)
    return AdamW(make_schedule(learning_rate, **kw), make_schedule(backbone_lr, **kw),
                 weight_decay, max_grad_norm, accum_steps,
                 scheduled=schedule not in (None, "none", "constant") or bool(warmup_steps))


def ordered_parameters(model: DETR) -> tuple[list[str], list[torch.nn.Parameter]]:
    """The model's parameters in Flax leaf order, with their state_dict keys;
    raises unless they are exactly the Flax params, leaf for leaf."""
    keys = [e.key for e in flax_param_map(model.config)]
    named = dict(model.named_parameters())
    if set(named) != set(keys):
        raise ValueError(f"parameters differ from the Flax leaves: {sorted(set(named) ^ set(keys))}")
    return keys, [named[k] for k in keys]


@dataclasses.dataclass
class TrainState:
    """Step count, the model, its params in Flax leaf order with their
    state_dict keys, the optimizer state and, with ``ema``, an exponential
    moving average of the params (the weights to serve)."""

    step: int
    model: DETR | None
    keys: list[str]
    params: list[torch.Tensor]
    opt_state: OptState
    ema_params: list[torch.Tensor] | None = None

    @classmethod
    def create(cls, model: DETR, tx: AdamW, ema: bool = False) -> "TrainState":
        keys, params = ordered_parameters(model)
        return cls(0, model, keys, params, tx.init(params),
                   [p.detach().clone() for p in params] if ema else None)


def apply_update(state: TrainState, grads: list[torch.Tensor], tx: AdamW,
                 ema_decay: float | None = None, norm_fn: Callable | None = None) -> TrainState:
    """Optimizer update and EMA, in place; the EMA advances only when the
    update is applied (every ``accum_steps``-th micro-step). ``norm_fn``:
    see :meth:`AdamW.update`."""
    if ema_decay is not None and state.ema_params is None:
        raise ValueError("ema_decay was requested but the TrainState carries no ema_params; "
                         "create it with TrainState.create(..., ema=True)")
    backbone = [k.startswith("backbone.") for k in state.keys]
    applied = tx.update(grads, state.opt_state, state.params, backbone, norm_fn)
    if applied and ema_decay is not None:
        d = np.float32(ema_decay)
        with torch.no_grad():
            torch._foreach_mul_(state.ema_params, float(d))
            torch._foreach_add_(state.ema_params, [p.detach() for p in state.params],
                                alpha=float(np.float32(1.0) - d))
    state.step += 1
    return state


def loss_fn(model: DETR, criterion: CriterionConfig, batch: dict, generator: torch.Generator | None,
            aux_loss: bool, mark: Callable[[str], None] = lambda _name: None, total_of=None):
    """Forward and set losses -> (total, metrics); ``mark`` is called after
    the forward, the matching and the losses (phase timing). ``total_of``:
    see ``criterion.detr_loss``."""
    out = model(batch["pixels"], batch["pixel_mask"], return_aux=aux_loss, generator=generator)
    mark("forward")
    labels, boxes, valid = batch["labels"], batch["boxes"], batch["valid"]
    logits, pred = out["logits"][None], out["boxes"][None]
    if aux_loss:  # deep supervision: every decoder layer, matched in one auction
        logits = torch.cat([out["aux_logits"], logits])
        pred = torch.cat([out["aux_boxes"], pred])
    L = logits.shape[0]
    idx = match(logits, pred, labels.expand(L, *labels.shape), boxes.expand(L, *boxes.shape),
                valid.expand(L, *valid.shape), criterion)
    mark("matcher")
    total, metrics = detr_loss(out["logits"], out["boxes"], labels, boxes, valid, criterion, idx[-1], total_of)
    if aux_loss:
        aux_total = torch.zeros((), device=total.device)
        for i in range(L - 1):
            aux_total = aux_total + detr_loss(logits[i], pred[i], labels, boxes, valid, criterion, idx[i],
                                              total_of)[0]
        total = total + aux_total
        metrics["loss_aux"] = aux_total
        metrics["loss"] = total
    if "enc_obj_logits" in out:
        enc = encoder_objectness_loss(out["enc_obj_logits"], out["feature_mask"], boxes, valid, criterion,
                                      total_of)
        total = total + criterion.w_enc_obj * enc
        metrics["loss_enc_obj"] = enc
        metrics["loss"] = total
    mark("loss")
    return total, metrics


def gradients(params: list[torch.Tensor]) -> list[torch.Tensor]:
    """The params' gradients (zeros for a leaf that got none, as JAX gives)."""
    return [torch.zeros_like(p) if p.grad is None else p.grad for p in params]


def make_train_step(model: DETR, tx: AdamW, criterion: CriterionConfig | None = None,
                    aux_loss: bool = True, ema_decay: float | None = None, augment=None) -> Callable:
    """(state, batch, generator[, mark]) -> (state, metrics): one step in
    place. ``batch`` holds ``pixels``, ``pixel_mask``, ``labels``, ``boxes``
    and ``valid`` on the model's device; ``generator`` is a CPU
    ``torch.Generator`` that the augmentation and the dropout draw from."""
    if criterion is None:
        criterion = CriterionConfig(num_classes=model.config.num_classes)

    def train_step(state: TrainState, batch: dict, generator: torch.Generator,
                   mark: Callable[[str], None] = lambda _name: None):
        if augment is not None:
            from .augment import augment_batch

            batch = augment_batch(generator, batch, augment)
        state.model.train()
        state.model.zero_grad(set_to_none=True)
        total, metrics = loss_fn(state.model, criterion, batch, generator, aux_loss, mark)
        total.backward()
        mark("backward")
        apply_update(state, gradients(state.params), tx, ema_decay)
        mark("optimizer")
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_sharded_train_step(model: DETR, tx: AdamW, mesh, criterion: CriterionConfig | None = None,
                            aux_loss: bool = True, ema_decay: float | None = None, augment=None) -> Callable:
    """The same step over a (data, model) grid of ranks (``parallel/``;
    JAX ``make_sharded_train_step``). Give it ``model`` already sharded
    (``parallel.sharding.shard_model``) and its ``TrainState``, and the
    whole batch on every rank, as the one-device step takes it.

    - data: each rank takes its slice of the batch after the whole batch's
      augmentation, drops what the one-device step drops on those samples
      (``models.layers.batch_draws``), divides its loss sums by the
      all-reduced box counts (``total_of``), and the gradients are
      all-reduced over the data ranks, so the update is the one-device
      step's;
    - model: the tensor-parallel layers all-reduce inside the forward and
      backward, and the clip's global norm sums the shards' squares over
      the model group.

    The metrics are the whole batch's (all-reduced; the cardinality error
    is a mean over the data ranks' equal slices)."""
    from ..models.layers import batch_draws
    from ..parallel.sharding import spec_of

    if criterion is None:
        criterion = CriterionConfig(num_classes=model.config.num_classes)
    data = mesh.data_group()

    def norm_fn(keys):
        sharded = [bool(spec_of(k)) for k in keys]

        def norm(grads):
            sq = [g.float().pow(2).sum() for g in grads]
            split = torch.stack([s for s, sh in zip(sq, sharded) if sh]).sum() if any(sharded) else sq[0] * 0
            if mesh.model_group is not None:
                torch.distributed.all_reduce(split, group=mesh.model_group)
            rest = torch.stack([s for s, sh in zip(sq, sharded) if not sh]).sum()
            return torch.sqrt(split + rest)

        return norm

    def train_step(state: TrainState, batch: dict, generator: torch.Generator,
                   mark: Callable[[str], None] = lambda _name: None):
        if augment is not None:
            from .augment import augment_batch

            batch = augment_batch(generator, batch, augment)  # the whole batch's draws
        batch = data.local(batch)
        state.model.train()
        state.model.zero_grad(set_to_none=True)
        with batch_draws(data.index, data.size):
            total, metrics = loss_fn(state.model, criterion, batch, generator, aux_loss, mark, data.all_sum)
        total.backward()
        mark("backward")
        grads = gradients(state.params)
        data.all_sum_(grads)
        apply_update(state, grads, tx, ema_decay, norm_fn(state.keys) if mesh.model_parallel > 1 else None)
        mark("optimizer")
        metrics = {k: data.all_sum(v) for k, v in metrics.items()}
        metrics["cardinality_error"] = metrics["cardinality_error"] / data.size
        return state, metrics

    return train_step
