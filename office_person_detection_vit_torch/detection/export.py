"""Deployable export of the fused detect program.

Mirrors ``office_person_detection_vit_tpu/detection/export.py``:
``export_detect`` (:29), ``save_exported`` (:110), ``load_exported`` (:117),
``run_exported`` (:146), ``save_weights_npz`` / ``load_weights_npz``
(:166-184) and ``ExportedDetector`` (:203), on ``torch.export`` in place of
``jax.export``.

The program is a detector's BGR route, preprocess -> model -> decode, traced
by ``torch.export`` into an ``ExportedProgram`` that reloads without the
model's Python code. Its calling convention is JAX's, flat:
``(params, frames_u8 (B, H, W, 3), orig_wh (2,) float32, conf () float32)
-> {"boxes_xywh", "scores", "valid", "foot"}``. The weights are a runtime
input (``params``, a dict of the model's state_dict tensors, through
``torch.func.functional_call``), so one artifact serves every fine-tune of
the same architecture; they travel as the path-keyed npz of JAX's
``save_weights_npz`` (the Flax paths and layouts, bf16 as tagged uint16).
The batch dimension is symbolic unless a fixed size is asked for.

The attention kernels are ctypes launches, which ``torch.export`` cannot
trace: the program records them as the operator
``torch.ops.office_person_detection_vit_torch.attention``
(``ops/attention.py::attention_op``), whose CUDA implementation is the
hand-written K1/K2 and whose CPU one is the plain version, so a program
exported on the card runs the kernels when it is loaded there.
:func:`load_exported` imports that module (registering the operator) before
``torch.export.load``. A program is exported on, and runs on, one device
type: the card's or the CPU's.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from ..models.weights import _DTYPE_TAG, flax_param_map, flat_leaves_from_state_dict, load_path_npz

logger = logging.getLogger(__name__)

OUTPUTS = ("boxes_xywh", "scores", "valid", "foot")
_META = "detect_program.json"


class _DetectProgram(torch.nn.Module):
    """A detector's BGR route as a function of (params, frames, orig_wh,
    conf) -> the four output tensors."""

    def __init__(self, detector):
        super().__init__()
        # Not a submodule: its weights are the program's input, not state
        # the artifact would carry.
        object.__setattr__(self, "detector", detector)

    def forward(self, params: dict, frames_u8: torch.Tensor, orig_wh: torch.Tensor, conf: torch.Tensor) -> dict:
        from ..ops.preprocessing import preprocess_frames

        det = self.detector
        if hasattr(det, "detr_config"):
            from ..models.postprocess import postprocess_detr

            cfg = det.detr_config
            pixels, mask = preprocess_frames(frames_u8, target_hw=det.input_hw, out_dtype=cfg.torch_dtype)
            out = torch.func.functional_call(det.model, params, (pixels, mask))
            return postprocess_detr(out["logits"], out["boxes"], orig_wh, conf, person_class_id=cfg.person_class_id,
                                    score_mode=cfg.score_mode, nms_iou=det.nms_threshold, host=False)
        cfg = det.model_config
        pixels, _ = preprocess_frames(frames_u8, target_hw=det.input_hw, out_dtype=cfg.torch_dtype)
        out = torch.func.functional_call(det.model, params, (pixels,))
        return det._decode_tensors(out, orig_wh, conf)


def model_params(detector) -> dict[str, torch.Tensor]:
    """The detector model's parameters and buffers by state_dict key."""
    return {k: v.detach() for k, v in detector.model.state_dict().items()}


def export_detect(detector, batch_size: int | None = None, source_hw: tuple[int, int] = (720, 1280)):
    """-> ``torch.export.ExportedProgram`` of the detector's BGR program on
    its device (DETR, YOLOv8 or the single-shot detector), for frames of
    ``source_hw``; ``batch_size`` a fixed int, or None (default) for a
    symbolic batch dimension."""
    if detector.model is None:
        detector.load_model()
    if getattr(detector, "mesh", None) is not None:
        raise ValueError("the export is a one-device program; export from a detector without a mesh")
    dev = detector.device
    H, W = source_hw
    b = 2 if batch_size is None else int(batch_size)
    args = (model_params(detector), torch.zeros(b, H, W, 3, dtype=torch.uint8, device=dev),
            torch.tensor([float(W), float(H)], device=dev), torch.tensor(0.5, device=dev))
    dynamic = None
    if batch_size is None:
        batch = torch.export.Dim("batch", min=1, max=1024)
        dynamic = ({k: None for k in args[0]}, {0: batch}, None, None)
    with torch.inference_mode(False), torch.no_grad():
        program = torch.export.export(_DetectProgram(detector).eval(), args, dynamic_shapes=dynamic, strict=False)
    program._detect_meta = {"source_hw": [H, W], "batch": batch_size,
                            "family": "detr" if hasattr(detector, "detr_config") else type(detector).__name__,
                            "params": {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
                                       for k, v in args[0].items()}}
    logger.info("exported detect program: batch=%s source=%dx%d device=%s", batch_size, H, W, dev)
    return program


def save_exported(exported, path: Path) -> int:
    """Write the program (``torch.export.save``, with its calling metadata);
    returns the byte size."""
    meta = json.dumps(exported._detect_meta)
    kept = exported.example_inputs
    exported.example_inputs = None  # the trace's example weights stay out of the artifact
    try:
        torch.export.save(exported, str(path), extra_files={_META: meta})
    finally:
        exported.example_inputs = kept
    return Path(path).stat().st_size


def load_exported(path: Path):
    """Load an exported detect program (no model code needed): the port's
    attention operator is registered first, which builds nothing until the
    program runs on the card. Its metadata is ``._detect_meta``."""
    from ..ops import attention  # noqa: F401 (registers torch.ops.office_person_detection_vit_torch.attention)

    extra = {_META: ""}
    program = torch.export.load(str(path), extra_files=extra)
    program._detect_meta = json.loads(extra[_META])
    return program


def run_exported(exported, variables: dict, frames_u8, orig_wh=(1280.0, 720.0), conf: float = 0.5) -> dict:
    """Run the program on its device -> the four outputs as host numpy.
    ``variables``: the program's params (a dict of tensors on its device,
    :func:`program_params`)."""
    device = next(iter(variables.values())).device
    module = getattr(exported, "_module_cache", None)
    if module is None:
        module = exported._module_cache = exported.module()
    with torch.inference_mode():
        out = module(variables, torch.as_tensor(np.asarray(frames_u8), device=device),
                     torch.as_tensor(orig_wh, dtype=torch.float32, device=device),
                     torch.tensor(float(conf), device=device))
    return {k: out[k].cpu().numpy() for k in OUTPUTS}


def save_weights_npz(detector_or_model, path: Path) -> int:
    """Write a model's weights as JAX's path-keyed npz (the Flax paths and
    layouts; bf16 leaves as uint16 under a dtype tag), readable without the
    model code. Returns the leaf count."""
    model = getattr(detector_or_model, "model", detector_or_model)
    cfg = model.config
    sd = model.state_dict()
    leaves = flat_leaves_from_state_dict(sd, cfg)
    flat = {}
    for e, leaf in zip(flax_param_map(cfg), leaves):
        name = "/".join(e.flax_path)
        if sd[e.key].dtype == torch.bfloat16:
            flat[f"{name}{_DTYPE_TAG}bfloat16"] = torch.from_numpy(leaf).bfloat16().view(torch.int16).numpy().view(
                np.uint16)
        else:
            flat[name] = leaf
    np.savez(path, **flat)
    return len(flat)


def load_weights_npz(path: Path) -> dict:
    """The nested variables dict of a path-keyed npz (numpy, float32)."""
    return load_path_npz(path)


def program_params(variables: dict, meta: dict, device) -> dict[str, torch.Tensor]:
    """A path-keyed variables dict -> the program's params (state_dict keys,
    the port's layouts, dtypes and shapes from the program's metadata):
    ``a/b/kernel`` -> ``a.b.weight`` (HWIO -> OIHW, (in, out) -> (out,
    in)), ``scale`` -> ``weight`` for a norm whose key the program has
    (``scale`` otherwise: frozen BN), other leaves by their dotted path."""
    flat: dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = v

    walk(variables.get("params", variables), ())
    wanted = meta["params"]
    out = {}
    for path, arr in flat.items():
        *mods, leaf = path.split("/")
        base = ".".join(mods)
        if leaf == "kernel":
            key = f"{base}.weight"
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif leaf == "scale" and f"{base}.weight" in wanted:
            key = f"{base}.weight"
        else:
            key = f"{base}.{leaf}" if base else leaf
        if key not in wanted:
            raise ValueError(f"weights leaf {path} has no parameter in the program ({key})")
        shape, dtype = wanted[key]
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        if list(t.shape) != shape:
            raise ValueError(f"weights leaf {path}: shape {tuple(t.shape)}, the program's {tuple(shape)}")
        out[key] = t.to(device=device, dtype=getattr(torch, dtype))
    missing = set(wanted) - set(out)
    if missing:
        raise ValueError(f"the weights lack {len(missing)} of the program's parameters, e.g. {sorted(missing)[:3]}")
    return {k: out[k] for k in wanted}  # the program's own order: its input is an ordered dict


class ExportedDetector:
    """The ``detect_batch`` contract backed by an exported program and a
    path-keyed weights npz, with no model construction, so ``serve.py
    --artifact ... --weights ...`` starts from two files.

    Frames of any size are resized to the program's ``source_hw`` on the
    host; the program decodes in that pixel space and the host stretches the
    boxes back per axis to the caller's size (the YOLO and single-shot
    decodes undo their letterbox with one scale, which is not per-axis).
    Fixed-batch programs pad partial batches; symbolic-batch ones run each
    chunk padded to a power-of-two bucket, as the live detectors do."""

    def __init__(self, artifact_path: Path, weights_path: Path, confidence_threshold: float = 0.5,
                 batch_size: int = 8, device: str = "auto"):
        from ..device import resolve_device

        self.exported = load_exported(artifact_path)
        meta = self.exported._detect_meta
        self.device = resolve_device(device)
        # resident on the device once, not uploaded with every call
        self.variables = program_params(load_weights_npz(weights_path), meta, self.device)
        self.confidence_threshold = float(confidence_threshold)
        self.source_hw = tuple(meta["source_hw"])
        self.exported_batch = meta["batch"]
        self.batch_size = self.exported_batch if self.exported_batch is not None else int(batch_size)
        self.model = self  # non-None, for callers that check for a loaded model

    def load_model(self) -> None:  # the program is the model
        pass

    def _bucket_sizes(self) -> list[int]:
        if self.exported_batch is not None:
            return [self.exported_batch]
        sizes, b = [], 1
        while b < self.batch_size:
            sizes.append(b)
            b <<= 1
        return sizes + [self.batch_size]

    def _bucket(self, n: int) -> int:
        if self.exported_batch is not None:
            return self.exported_batch
        b = 1
        while b < n:
            b <<= 1
        return min(b, self.batch_size)

    def detect_batch(self, frames: np.ndarray):
        import cv2

        from ..core.dto import DetectionBatch

        h, w = self.source_hw
        F = int(frames.shape[0])
        if F == 0:
            q = 0
            return DetectionBatch(boxes_xywh=np.zeros((0, q, 4), np.float32), scores=np.zeros((0, q), np.float32),
                                  valid=np.zeros((0, q), bool), foot=np.zeros((0, q, 2), np.float32))
        _, H0, W0, _ = frames.shape
        resized = (int(H0), int(W0)) != (h, w)
        if resized:
            frames = np.stack([cv2.resize(f, (w, h)) for f in frames])
        outs, i = [], 0
        while i < F:
            n = min(self.batch_size, F - i)
            m = self._bucket(n)
            part = frames[i:i + n]
            if len(part) < m:
                part = np.concatenate([part, np.zeros((m - len(part), h, w, 3), np.uint8)])
            out = run_exported(self.exported, self.variables, part, orig_wh=(float(w), float(h)),
                               conf=self.confidence_threshold)
            outs.append({k: v[:n] for k, v in out.items()})
            i += n
        cat = {k: np.concatenate([o[k] for o in outs]) for k in OUTPUTS}
        if resized:
            sx, sy = float(W0) / w, float(H0) / h
            cat["boxes_xywh"] = cat["boxes_xywh"] * np.asarray([sx, sy, sx, sy], np.float32)
            cat["foot"] = cat["foot"] * np.asarray([sx, sy], np.float32)
        return DetectionBatch(**cat)
