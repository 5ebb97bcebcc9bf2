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
- :func:`flat_leaves_from_state_dict` / :func:`save_flat_npz`: the reverse
  map, port state_dict -> the flat ``leaf_i`` npz that the JAX trainer writes
  and :func:`load_flat_npz` (and the JAX package's ``load_any_checkpoint``)
  reads;
- :func:`state_dict_from_hf`: a HF ``DetrForObjectDetection`` state_dict
  (HF-native or timm backbone names) by key mapping, BN folded as in
  ``convert_torch_state_dict``;
- :func:`convert_vit_state_dict`: a HF ``ViTModel`` state_dict -> the Flax
  params of a ViT backbone, as the JAX package's function of that name
  returns them (the ``backbone`` subtree of a ViT DETR, or a
  ``ViTBackbone`` through :func:`state_dict_from_flax` with its
  ``ViTConfig``).

Every map covers the ViT DETR (``DETRConfig(backbone="vit")``) as well: its
backbone's Flax names are the port's module names. The Flax maps and the flat
npz take a ``YOLOConfig`` or a ``SingleShotConfig`` as well, for the
single-shot families (``models/yolo.py``, ``models/single_shot.py``), whose
module names are their Flax names too; and
:func:`convert_yolov8_state_dict` carries an ultralytics ``DetectionModel``
state_dict into the port's YOLOv8 (JAX ``models/weights.py:222-307``).

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
from .single_shot import SingleShotConfig, SingleShotDetector
from .vit import ViTBackbone, ViTConfig
from .yolo import YOLOConfig, YOLOv8

#: A configuration of any model the maps take.
ModelConfig = DETRConfig | ViTConfig | YOLOConfig | SingleShotConfig


def build_model(config: ModelConfig) -> nn.Module:
    """The port's model of ``config``: DETR, a ViT backbone on its own, YOLOv8
    or the single-shot detector."""
    if isinstance(config, ViTConfig):
        return ViTBackbone(config)
    if isinstance(config, YOLOConfig):
        return YOLOv8(config)
    if isinstance(config, SingleShotConfig):
        return SingleShotDetector(config)
    return DETR(config)

BN_EPS = 1e-5
_DTYPE_TAG = "##dtype="


class ParamEntry(NamedTuple):
    flax_path: tuple[str, ...]  # ("params", ..., leaf)
    key: str  # the port's state_dict key
    kind: str  # "conv" | "dense" | "copy"
    flax_shape: tuple[int, ...]


def flax_param_map(config: ModelConfig) -> list[ParamEntry]:
    """Every parameter of the model of ``config`` (:func:`build_model`) as
    (Flax path, port key), in the order ``jax.tree_util`` flattens the Flax
    variables."""
    with torch.device("meta"):
        model = build_model(config)
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
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            add(path + ("scale",), f"{name}.weight", "copy", mod.weight)
            add(path + ("bias",), f"{name}.bias", "copy", mod.bias)
        elif isinstance(mod, FrozenBatchNorm):
            add(path + ("scale",), f"{name}.scale", "copy", mod.scale)
            add(path + ("bias",), f"{name}.bias", "copy", mod.bias)
    # Parameters held by no layer: DETR's query embeddings, the ViT's CLS
    # token and position embeddings.
    covered = {e.key for e in entries}
    for key, p in model.named_parameters():
        if key not in covered:
            add(tuple(key.split(".")), key, "copy", p)
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


def state_dict_from_flax(variables: Mapping[str, Any], config: ModelConfig) -> dict[str, torch.Tensor]:
    """Flax variables ``{"params": {...}}`` (numpy leaves) -> port state_dict
    (float32) of the model of ``config`` (:func:`build_model`)."""
    entries = flax_param_map(config)
    n = _count_leaves(variables["params"])
    if n != len(entries):
        raise ValueError(f"variables hold {n} params, {config} has {len(entries)}")
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


def load_flat_npz(path, config: ModelConfig) -> dict:
    """Trainer's flat ``leaf_i`` npz -> nested variables dict, leaf order from
    :func:`flax_param_map` (no JAX needed)."""
    entries = flax_param_map(config)
    out: dict = {}
    with np.load(path) as data:
        if len(data.files) != len(entries):
            raise ValueError(f"{path}: {len(data.files)} leaves, {config} has {len(entries)}")
        for i, e in enumerate(entries):
            arr = data[f"leaf_{i}"]
            if arr.shape != e.flax_shape:
                raise ValueError(
                    f"{path}: leaf_{i} ({'/'.join(e.flax_path)}) has shape {arr.shape}, "
                    f"expected {e.flax_shape}"
                )
            _set(out, e.flax_path, arr)
    return out


def flat_leaves_from_state_dict(sd: Mapping[str, torch.Tensor], config: ModelConfig) -> list[np.ndarray]:
    """Port state_dict -> float32 Flax leaves in flattening order (conv
    OIHW -> HWIO, dense (out, in) -> (in, out))."""
    leaves = []
    for e in flax_param_map(config):
        arr = sd[e.key].detach().float().cpu().numpy()
        if e.kind == "conv":
            arr = arr.transpose(2, 3, 1, 0)
        elif e.kind == "dense":
            arr = arr.T
        leaves.append(np.ascontiguousarray(arr, np.float32))
    return leaves


def save_flat_npz(path, sd: Mapping[str, torch.Tensor], config: ModelConfig) -> None:
    """Write ``sd`` as the trainer's flat ``leaf_i`` npz (``weights.npz``)."""
    leaves = flat_leaves_from_state_dict(sd, config)
    np.savez(path, **{f"leaf_{i}": a for i, a in enumerate(leaves)})


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


def convert_vit_state_dict(sd: Mapping[str, Any], num_layers: int = 12) -> dict:
    """HF ``transformers.ViTModel`` state_dict -> ``{"params": ...}`` of a
    ViT backbone, keyed as ``models/vit.py``'s modules (the JAX package's
    ``convert_vit_state_dict``)."""
    params: dict = {
        "cls_token": _np(sd, "embeddings.cls_token"),
        "position_embeddings": _np(sd, "embeddings.position_embeddings"),
        "patch_embed": {**_conv(sd, "embeddings.patch_embeddings.projection.weight"),
                        "bias": _np(sd, "embeddings.patch_embeddings.projection.bias")},
        "layernorm": _ln(sd, "layernorm"),
    }
    for i in range(num_layers):
        p = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "attention": {
                "q_proj": _dense(sd, f"{p}.attention.attention.query"),
                "k_proj": _dense(sd, f"{p}.attention.attention.key"),
                "v_proj": _dense(sd, f"{p}.attention.attention.value"),
                "out_proj": _dense(sd, f"{p}.attention.output.dense"),
            },
            "layernorm_before": _ln(sd, f"{p}.layernorm_before"),
            "layernorm_after": _ln(sd, f"{p}.layernorm_after"),
            "intermediate": _dense(sd, f"{p}.intermediate.dense"),
            "output": _dense(sd, f"{p}.output.dense"),
        }
    return {"params": params}


def load_checkpoint(path, config: ModelConfig) -> dict[str, torch.Tensor]:
    """Any weight file the detector of ``config`` takes -> port state_dict
    (JAX ``load_any_checkpoint``, :325): a flat or a path-keyed ``.npz`` for
    every family; for DETR a HF ``.pt``/``.bin``/``.safetensors``; for YOLOv8
    an ultralytics ``.pt``/``.pth``/``.bin`` (:func:`convert_yolov8_state_dict`).
    The JAX package's orbax directories need JAX to read and are not taken."""
    p = Path(str(path))
    if p.suffix == ".npz":
        with np.load(p) as data:
            flat = "leaf_0" in data.files
        variables = load_flat_npz(p, config) if flat else load_path_npz(p)
        return state_dict_from_flax(variables, config)
    if isinstance(config, YOLOConfig) and p.suffix in (".pt", ".pth", ".bin"):
        sd = torch.load(p, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
            sd = sd["model"]
        return state_dict_from_flax(convert_yolov8_state_dict(sd), config)
    if not isinstance(config, DETRConfig):
        raise ValueError(f"unsupported checkpoint format for {type(config).__name__}: {p}")
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


# ------------------------------------------------------------- ultralytics
#: ultralytics BatchNorm2d eps (their Conv block overrides torch's 1e-5).
YOLO_BN_EPS = 1e-3


def _fold_bn_eps(sd, prefix: str, eps: float) -> dict:
    scale = _np(sd, f"{prefix}.weight") / np.sqrt(_np(sd, f"{prefix}.running_var") + eps)
    return {"scale": scale, "bias": _np(sd, f"{prefix}.bias") - _np(sd, f"{prefix}.running_mean") * scale}


def convert_yolov8_state_dict(sd: Mapping[str, Any]) -> dict:
    """ultralytics ``DetectionModel.state_dict()`` -> the Flax params of a
    YOLOv8, as JAX ``convert_yolov8_state_dict`` returns them (numpy; the
    port's state_dict through :func:`state_dict_from_flax` with its
    ``YOLOConfig``).

    ``model.{i}.conv`` / ``model.{i}.bn`` -> ``m{i}/conv|bn``;
    ``model.{i}.cv1|cv2`` and ``model.{i}.m.{j}.cv1|cv2`` -> ``m{i}/cv1``,
    ``m{i}/m{j}/cv1``; ``model.22.cv2|cv3.{l}.{0,1}`` ->
    ``detect/cv2_{l}_{0,1}``; the plain ``model.22.cv2|cv3.{l}.2`` convs
    with their bias -> ``detect/cv2_{l}_2``. BN folds with eps 1e-3; the
    fixed ``dfl.conv`` kernel is dropped (``models/yolo.py::dfl_expectation``
    is its closed form). Bare ``model.N`` keys or a ``model.model.N``
    wrapper; other keys are ignored."""
    if any(k.startswith("model.model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.model.")}
    params: dict = {}
    for key in sd:
        m = re.match(r"model\.(\d+)\.(.*)$", key)
        if not m:
            continue
        idx, rest = int(m.group(1)), m.group(2)
        cm = re.match(r"((?:m\.\d+\.)?cv\d\.|)(conv)\.weight$", rest)
        if cm:  # ConvBlocks of the backbone and neck: m{i}[/m{j}][/cv{k}]
            inner = cm.group(1).rstrip(".")
            toks = [t for t in inner.split(".") if t]
            norm, i = [], 0
            while i < len(toks):
                if toks[i] == "m" and i + 1 < len(toks) and toks[i + 1].isdigit():
                    norm.append(f"m{toks[i + 1]}")
                    i += 2
                else:
                    norm.append(toks[i])
                    i += 1
            path = (f"m{idx}", *norm)
            _set(params, path + ("conv",), _conv(sd, key))
            _set(params, path + ("bn",), _fold_bn_eps(sd, f"model.{idx}.{inner + '.' if inner else ''}bn",
                                                      YOLO_BN_EPS))
            continue
        hm = re.match(r"(cv[23])\.(\d+)\.(\d+)\.conv\.weight$", rest)
        if hm:  # the head's ConvBlocks
            name = f"{hm.group(1)}_{hm.group(2)}_{hm.group(3)}"
            _set(params, ("detect", name, "conv"), _conv(sd, key))
            _set(params, ("detect", name, "bn"),
                 _fold_bn_eps(sd, f"model.{idx}.{hm.group(1)}.{hm.group(2)}.{hm.group(3)}.bn", YOLO_BN_EPS))
            continue
        hm = re.match(r"(cv[23])\.(\d+)\.2\.weight$", rest)
        if hm:  # the head's plain 1x1 output convs
            leaf = _conv(sd, key)
            bias_key = f"model.{idx}.{hm.group(1)}.{hm.group(2)}.2.bias"
            if bias_key in sd:
                leaf["bias"] = _np(sd, bias_key)
            _set(params, ("detect", f"{hm.group(1)}_{hm.group(2)}_2"), leaf)
    return {"params": params}
