"""Layers that keep float32 parameters and compute in their input's dtype.

Flax modules hold float32 params and cast each one to the module's ``dtype``
where it is used; these do the same, so a bf16 model trains float32 master
weights: the cast's backward hands a float32 gradient to the float32
parameter, and an AdamW update of 1e-5 x a weight is not rounded away as it
would be in bf16. Where the parameters are already in the input's dtype (the
detector moves its model to its dtype once) the cast is a no-op, and the
numbers are those of plain ``nn.Linear`` / ``nn.Conv2d`` / ``nn.LayerNorm``.

Chosen over ``torch.autocast``, which would run LayerNorm and the softmax in
float32 and leave elementwise work in whatever dtype reaches it: a placement
of casts that neither the JAX package nor the port's detect path has.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, _cast(self.weight, x.dtype),
                            _cast(self.bias, x.dtype), self.eps)


#: The slice of the whole batch that this rank's tensors hold, as (index,
#: count) of equal slices, while a data-parallel step runs
#: (:func:`batch_draws`); None otherwise.
_batch_slice: tuple[int, int] | None = None


@contextlib.contextmanager
def batch_draws(index: int, count: int):
    """Within the block, :func:`dropout` draws the whole batch's mask and
    keeps slice ``index`` of ``count``, so that a data-parallel rank drops
    what the one-device step drops on its samples."""
    global _batch_slice
    saved, _batch_slice = _batch_slice, (index, count)
    try:
        yield
    finally:
        _batch_slice = saved


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None,
            feature_shard: tuple[int, int] | None = None) -> torch.Tensor:
    """Inverted dropout drawn from ``generator`` (``None``: off), as Flax's
    ``nn.Dropout``: keep where a uniform draw is below 1 - p, scale the kept
    values by 1 / (1 - p), zero the rest. ``feature_shard`` (index, count):
    ``x`` is that slice of the last axis (a tensor-parallel layer's output);
    the mask is drawn at the full width and sliced, and so is the batch axis
    under :func:`batch_draws`."""
    if generator is None or p == 0.0:
        return x
    keep = 1.0 - p
    shape = list(x.shape)
    if _batch_slice is not None:
        shape[0] *= _batch_slice[1]
    if feature_shard is not None:
        shape[-1] *= feature_shard[1]
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if _batch_slice is not None:
        i, n = _batch_slice[0], x.shape[0]
        mask = mask[i * n:(i + 1) * n]
    if feature_shard is not None:
        i, n = feature_shard[0], x.shape[-1]
        mask = mask[..., i * n:(i + 1) * n]
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def layer_generator(seed: int | None, device: torch.device) -> torch.Generator | None:
    """A generator on ``device`` seeded from a layer's seed (``None``: no
    dropout). A layer that runs again under ``torch.utils.checkpoint`` gets
    the same seed, so it draws the same masks."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)
