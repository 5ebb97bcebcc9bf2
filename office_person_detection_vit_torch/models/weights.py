"""Carry weights into the port's DETR.

Mirrors ``office_person_detection_vit_tpu/models/weights.py`` (HF checkpoint
conversion) and the weight files of ``detection/export.py`` and the trainer:

- :func:`state_dict_from_flax`: the JAX package's variables (a nested dict of
  numpy arrays) -> the port's state_dict. Conv kernels HWIO -> OIHW, Dense
  kernels (in, out) -> (out, in), LayerNorm scale -> weight; FrozenBN
  scale/bias and everything else as they are.
- :func:`load_path_npz`: the path-keyed npz of ``save_weights_npz``, bf16
  leaves included (stored as uint16 under a ``##dtype=bfloat16`` tag).
- :func:`load_flat_npz`: the trainer's flat ``leaf_i`` npz. ``jax.tree_util``
  flattens nested dicts in sorted key order at every level, so the leaf order
  is the sorted order of the Flax paths that :func:`flax_param_map`
  enumerates for a config (string order: ``layer_10`` < ``layer_2``).
- :func:`state_dict_from_hf`: a HF ``DetrForObjectDetection`` state_dict
  (HF-native or timm backbone names) by key mapping, BN folded as in
  ``convert_torch_state_dict``.

The port's module names are the Flax module names, so one walk over the
port's own modules gives the whole mapping.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch
from torch import nn

from .detr import DETR, DETRConfig
from .resnet import FrozenBatchNorm

BN_EPS = 1e-5
_DTYPE_TAG = "##dtype="


class ParamEntry(NamedTuple):
    flax_path: tuple[str, ...]  # ("params", ..., leaf)
    key: str  # the port's state_dict key
    kind: str  # "conv" | "dense" | "copy"
    flax_shape: tuple[int, ...]


def flax_param_map(config: DETRConfig) -> list[ParamEntry]:
    """Every parameter of DETR(config) as (Flax path, port key), in the order
    ``jax.tree_util`` flattens the Flax variables."""
    with torch.device("meta"):
        model = DETR(config)
    entries = []

    def add(path, key, kind, tensor):
        shape = tuple(tensor.shape)
        if kind == "conv":
            shape = (shape[2], shape[3], shape[1], shape[0])
        elif kind == "dense":
            shape = shape[::-1]
        entries.append(ParamEntry(("params",) + path, key, kind, shape))

    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            add(path + ("kernel",), f"{name}.weight",
                "conv" if isinstance(mod, nn.Conv2d) else "dense", mod.weight)
            if mod.bias is not None:
                add(path + ("bias",), f"{name}.bias", "copy", mod.bias)
        elif isinstance(mod, nn.LayerNorm):
            add(path + ("scale",), f"{name}.weight", "copy", mod.weight)
            add(path + ("bias",), f"{name}.bias", "copy", mod.bias)
        elif isinstance(mod, FrozenBatchNorm):
            add(path + ("scale",), f"{name}.scale", "copy", mod.scale)
            add(path + ("bias",), f"{name}.bias", "copy", mod.bias)
    add(("query_position_embeddings",), "query_position_embeddings", "copy",
        model.query_position_embeddings)
    return sorted(entries, key=lambda e: e.flax_path)


def _leaf(tree: Mapping[str, Any], path: tuple[str, ...]) -> np.ndarray:
    node: Any = tree
    for p in path:
        node = node[p]
    return np.asarray(node, np.float32)


def _count_leaves(tree: Any) -> int:
    if isinstance(tree, Mapping):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def state_dict_from_flax(variables: Mapping[str, Any], config: DETRConfig) -> dict[str, torch.Tensor]:
    """Flax variables ``{"params": {...}}`` (numpy leaves) -> port state_dict (float32)."""
    entries = flax_param_map(config)
    n = _count_leaves(variables["params"])
    if n != len(entries):
        raise ValueError(f"variables hold {n} params, DETR({config}) has {len(entries)}")
    sd = {}
    for e in entries:
        arr = _leaf(variables, e.flax_path)
        if arr.shape != e.flax_shape:
            raise ValueError(f"{'/'.join(e.flax_path)}: shape {arr.shape}, expected {e.flax_shape}")
        if e.kind == "conv":
            arr = arr.transpose(3, 2, 0, 1)
        elif e.kind == "dense":
            arr = arr.T
        sd[e.key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return sd


def _set(tree: dict, path: tuple[str, ...], value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def load_path_npz(path) -> dict:
    """Path-keyed npz (``detection/export.py::save_weights_npz``) -> nested
    dict of float32 numpy arrays; bf16 leaves are widened exactly."""
    out: dict = {}
    with np.load(path) as data:
        for name in data.files:
            arr = data[name]
            if _DTYPE_TAG in name:
                name, dtype_name = name.split(_DTYPE_TAG)
                if dtype_name != "bfloat16":
                    raise ValueError(f"unsupported tagged dtype {dtype_name!r} in {path}")
                arr = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).float().numpy()
            _set(out, tuple(name.split("/")), arr)
    return out


def load_flat_npz(path, config: DETRConfig) -> dict:
    """Trainer's flat ``leaf_i`` npz -> nested variables dict, leaf order from
    :func:`flax_param_map` (no JAX needed)."""
    entries = flax_param_map(config)
    out: dict = {}
    with np.load(path) as data:
        if len(data.files) != len(entries):
            raise ValueError(f"{path}: {len(data.files)} leaves, DETR({config}) has {len(entries)}")
        for i, e in enumerate(entries):
            arr = data[f"leaf_{i}"]
            if arr.shape != e.flax_shape:
                raise ValueError(
                    f"{path}: leaf_{i} ({'/'.join(e.flax_path)}) has shape {arr.shape}, "
                    f"expected {e.flax_shape}"
                )
            _set(out, e.flax_path, arr)
    return out


# ------------------------------------------------------------------ HF names
def _np(sd, key) -> np.ndarray:
    v = sd[key]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def _fold_bn(sd, prefix: str) -> dict:
    scale = _np(sd, f"{prefix}.weight") / np.sqrt(_np(sd, f"{prefix}.running_var") + BN_EPS)
    return {"scale": scale, "bias": _np(sd, f"{prefix}.bias") - _np(sd, f"{prefix}.running_mean") * scale}


def _conv(sd, key: str) -> dict:
    return {"kernel": _np(sd, key).transpose(2, 3, 1, 0)}


def _dense(sd, prefix: str) -> dict:
    out = {"kernel": _np(sd, f"{prefix}.weight").T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd, f"{prefix}.bias")
    return out


def _ln(sd, prefix: str) -> dict:
    return {"scale": _np(sd, f"{prefix}.weight"), "bias": _np(sd, f"{prefix}.bias")}


def _hf_backbone(sd) -> dict:
    out: dict = {}
    hf = "model.backbone.conv_encoder.model"
    if f"{hf}.embedder.embedder.convolution.weight" in sd:
        out["embedder_conv"] = _conv(sd, f"{hf}.embedder.embedder.convolution.weight")
        out["embedder_bn"] = _fold_bn(sd, f"{hf}.embedder.embedder.normalization")
        for key in sd:
            m = re.match(re.escape(hf) + r"\.encoder\.stages\.(\d+)\.layers\.(\d+)\.(layer\.(\d+)|shortcut)\.convolution\.weight$", key)
            if not m:
                continue
            s, l = int(m.group(1)), int(m.group(2))
            blk = out.setdefault(f"stage{s}_layer{l}", {})
            prefix = key[: -len(".convolution.weight")]
            name = f"conv{m.group(4)}" if m.group(4) is not None else "shortcut_conv"
            blk[name] = _conv(sd, key)
            blk[name.replace("conv", "bn")] = _fold_bn(sd, f"{prefix}.normalization")
    elif f"{hf}.conv1.weight" in sd:
        out["embedder_conv"] = _conv(sd, f"{hf}.conv1.weight")
        out["embedder_bn"] = _fold_bn(sd, f"{hf}.bn1")
        for key in sd:
            m = re.match(re.escape(hf) + r"\.layer(\d)\.(\d+)\.(conv(\d)|downsample\.0)\.weight$", key)
            if not m:
                continue
            s, l = int(m.group(1)) - 1, int(m.group(2))
            blk = out.setdefault(f"stage{s}_layer{l}", {})
            if m.group(4) is not None:
                j = int(m.group(4)) - 1
                blk[f"conv{j}"] = _conv(sd, key)
                blk[f"bn{j}"] = _fold_bn(sd, f"{hf}.layer{s + 1}.{l}.bn{j + 1}")
            else:
                blk["shortcut_conv"] = _conv(sd, key)
                blk["shortcut_bn"] = _fold_bn(sd, f"{hf}.layer{s + 1}.{l}.downsample.1")
    else:
        raise ValueError("unrecognized backbone naming in state_dict")
    return out


def _hf_attention(sd, prefix: str) -> dict:
    return {n: _dense(sd, f"{prefix}.{n}") for n in ("q_proj", "k_proj", "v_proj", "out_proj")}


def _hf_layer(sd, prefix: str, decoder: bool) -> dict:
    out = {
        "self_attn": _hf_attention(sd, f"{prefix}.self_attn"),
        "self_attn_layer_norm": _ln(sd, f"{prefix}.self_attn_layer_norm"),
        "fc1": _dense(sd, f"{prefix}.fc1"),
        "fc2": _dense(sd, f"{prefix}.fc2"),
        "final_layer_norm": _ln(sd, f"{prefix}.final_layer_norm"),
    }
    if decoder:
        out["encoder_attn"] = _hf_attention(sd, f"{prefix}.encoder_attn")
        out["encoder_attn_layer_norm"] = _ln(sd, f"{prefix}.encoder_attn_layer_norm")
    return out


def state_dict_from_hf(sd: Mapping[str, Any], config: DETRConfig) -> dict[str, torch.Tensor]:
    """HF ``DetrForObjectDetection`` state_dict -> port state_dict."""
    params = {
        "backbone": _hf_backbone(sd),
        "input_projection": {
            "kernel": _np(sd, "model.input_projection.weight").transpose(2, 3, 1, 0),
            "bias": _np(sd, "model.input_projection.bias"),
        },
        "query_position_embeddings": _np(sd, "model.query_position_embeddings.weight"),
        "encoder": {
            f"layer_{i}": _hf_layer(sd, f"model.encoder.layers.{i}", decoder=False)
            for i in range(config.num_encoder_layers)
        },
        "decoder": {
            f"layer_{i}": _hf_layer(sd, f"model.decoder.layers.{i}", decoder=True)
            for i in range(config.num_decoder_layers)
        },
        "class_labels_classifier": _dense(sd, "class_labels_classifier"),
        "bbox_predictor": {f"dense{j}": _dense(sd, f"bbox_predictor.layers.{j}") for j in range(3)},
    }
    params["decoder"]["layernorm"] = _ln(sd, "model.decoder.layernorm")
    return state_dict_from_flax({"params": params}, config)


def load_checkpoint(path, config: DETRConfig) -> dict[str, torch.Tensor]:
    """Any weight file the detector takes -> port state_dict: a flat or a
    path-keyed ``.npz``, or a HF ``.pt``/``.bin``/``.safetensors``."""
    p = Path(str(path))
    if p.suffix == ".npz":
        with np.load(p) as data:
            flat = "leaf_0" in data.files
        variables = load_flat_npz(p, config) if flat else load_path_npz(p)
        return state_dict_from_flax(variables, config)
    if p.suffix == ".safetensors":
        from safetensors.torch import load_file

        sd = load_file(str(p))
    elif p.suffix in (".pt", ".bin"):
        sd = torch.load(p, map_location="cpu", weights_only=True)
        if "model" in sd and isinstance(sd["model"], dict):
            sd = sd["model"]
    else:
        raise ValueError(f"unsupported checkpoint format: {p}")
    return state_dict_from_hf(sd, config)
