"""Tensor-parallel partition rules and layers for DETR (Megatron style).

Mirrors ``office_person_detection_vit_tpu/parallel/sharding.py``: the same
rules as ``_TP_RULES`` (:27-48), written over the port's state_dict keys,
first match wins:

- q/k/v projections column-parallel: weight (out, in) split on out, bias
  split; each model rank holds a subset of the heads, and its attention is
  the hand-written kernel on those heads alone, with no communication;
- attention ``out_proj`` row-parallel: weight split on in, bias replicated;
- FFN ``fc1`` column-parallel, ``fc2`` row-parallel; the ViT blocks'
  ``intermediate``/``output`` the same;
- everything else (the backbone's convolutions, norms, embeddings, heads)
  replicated.

JAX lets GSPMD derive the collectives from these annotations; here they are
explicit (:func:`shard_model`): a column-parallel layer's input passes
through an identity whose backward all-reduces the input gradient over the
model group, and a row-parallel layer all-reduces its partial products in
the forward and adds its bias after. Plain modules rather than DTensor: the
attention kernels are ctypes launches that DTensor cannot propagate
through. :func:`param_specs` (:55) and :func:`shard_params` (:68) have the
JAX signatures' roles, over a state_dict: a spec is a tuple a dim long with
``"model"`` on the split dim, ``()`` for replicated.
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.layers import Linear
from .mesh import MODEL_AXIS, Mesh

COLUMN_WEIGHT, COLUMN_BIAS, ROW_WEIGHT = (MODEL_AXIS, None), (MODEL_AXIS,), (None, MODEL_AXIS)

#: (state_dict key regex, spec), first match wins.
TP_RULES: list[tuple[str, tuple]] = [
    (r"(self_attn|encoder_attn)\.(q|k|v)_proj\.weight$", COLUMN_WEIGHT),
    (r"(self_attn|encoder_attn)\.(q|k|v)_proj\.bias$", COLUMN_BIAS),
    (r"(self_attn|encoder_attn)\.out_proj\.weight$", ROW_WEIGHT),
    (r"fc1\.weight$", COLUMN_WEIGHT),
    (r"fc1\.bias$", COLUMN_BIAS),
    (r"fc2\.weight$", ROW_WEIGHT),
    # the ViT backbone's blocks (models/vit.py), its attention and MLP
    (r"backbone\.layer_\d+\.attention\.(q|k|v)_proj\.weight$", COLUMN_WEIGHT),
    (r"backbone\.layer_\d+\.attention\.(q|k|v)_proj\.bias$", COLUMN_BIAS),
    (r"backbone\.layer_\d+\.attention\.out_proj\.weight$", ROW_WEIGHT),
    (r"backbone\.layer_\d+\.intermediate\.weight$", COLUMN_WEIGHT),
    (r"backbone\.layer_\d+\.intermediate\.bias$", COLUMN_BIAS),
    (r"backbone\.layer_\d+\.output\.weight$", ROW_WEIGHT),
]


def spec_of(key: str) -> tuple:
    for pattern, spec in TP_RULES:
        if re.search(pattern, key):
            return spec
    return ()


def param_specs(keys) -> dict[str, tuple]:
    """Spec of each state_dict key (``()`` = replicated)."""
    return {k: spec_of(k) for k in keys}


def split_dim(spec: tuple) -> int | None:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def shard(t: torch.Tensor, spec: tuple, index: int, count: int) -> torch.Tensor:
    """Model rank ``index``'s part of ``t`` under ``spec``."""
    dim = split_dim(spec)
    if dim is None:
        return t
    if t.shape[dim] % count:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {count} model ranks")
    return t.chunk(count, dim)[index]


def shard_params(state_dict: dict, mesh: Mesh) -> dict:
    """This rank's parameters under the rules (the JAX placement)."""
    return {k: shard(v, spec_of(k), mesh.model_index, mesh.model_parallel) for k, v in state_dict.items()}


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward all-reduces the gradient over the model
    group (the input of a column-parallel layer feeds every rank's part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce of the partial products over the model group; identity
    backward (each rank's partial gets the whole output's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class ColumnParallelLinear(Linear):
    """``Linear`` holding rows [i*n, (i+1)*n) of the weight and bias:
    this rank's output features."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_CopyToModel.apply(x, self.group))


class RowParallelLinear(Linear):
    """``Linear`` holding columns [i*n, (i+1)*n) of the weight and the whole
    bias: the partial products of this rank's input features, summed over
    the model group, then the bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype))
        return _ReduceFromModel.apply(y, self.group) + self.bias.to(y.dtype)


def _parallel_linear(linear: nn.Linear, cls, spec_w, group, index: int, count: int) -> nn.Module:
    out = cls.__new__(cls)
    nn.Module.__init__(out)
    out.in_features, out.out_features = linear.in_features, linear.out_features
    out.weight = nn.Parameter(shard(linear.weight.detach(), spec_w, index, count).clone())
    bias = linear.bias.detach()
    out.bias = nn.Parameter((shard(bias, COLUMN_BIAS, index, count) if cls is ColumnParallelLinear else bias).clone())
    out.group = group
    out.shard = (index, count)
    return out


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Replace, in place, every linear layer a rule splits by its
    column- or row-parallel counterpart holding this rank's part, and give
    each sharded attention its share of the heads. The state_dict keys stay
    the same. With one model rank the model is returned unchanged."""
    if mesh.model_parallel == 1:
        return model
    from ..models.transformer import MultiHeadAttention

    index, count, group = mesh.model_index, mesh.model_parallel, mesh.model_group
    for name, module in list(model.named_modules()):
        for child_name, child in list(module.named_children()):
            key = f"{name}.{child_name}.weight" if name else f"{child_name}.weight"
            spec = spec_of(key)
            if isinstance(child, nn.Linear) and spec:
                cls = ColumnParallelLinear if spec == COLUMN_WEIGHT else RowParallelLinear
                setattr(module, child_name, _parallel_linear(child, cls, spec, group, index, count))
        if isinstance(module, MultiHeadAttention) and isinstance(module.q_proj, ColumnParallelLinear):
            if module.num_heads % count:
                raise ValueError(f"{name}: {module.num_heads} heads do not split over {count} model ranks")
            module.num_heads //= count
    return model


def gather_full(tensors: list[torch.Tensor], keys: list[str], mesh: Mesh) -> list[torch.Tensor]:
    """The whole tensors of this rank's shards (``keys`` name them): the
    model group's parts concatenated on each split dim; replicated ones as
    they are. Every rank of the model group must call it."""
    out = []
    for t, k in zip(tensors, keys):
        dim = split_dim(spec_of(k))
        if dim is None or mesh.model_parallel == 1:
            out.append(t)
            continue
        parts = [torch.empty_like(t) for _ in range(mesh.model_parallel)]
        dist.all_gather(parts, t.detach().contiguous(), group=mesh.model_group)
        out.append(torch.cat(parts, dim))
    return out
