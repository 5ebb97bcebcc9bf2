"""DETRDetector: batched DETR person detection.

Mirrors ``office_person_detection_vit_tpu/detection/detector.py``: the same
constructor (any config with ``.get(dotted_key, default)``: the JAX
package's ``ConfigManager``, or a plain dict of dotted keys),
``load_model``, ``detect_batch``, ``detect`` and ``cleanup``; power-of-two
tail buckets, per-chunk failure isolation and ``detection.nms_threshold`` as
the JAX detector reads them. A chunk runs preprocess -> DETR -> postprocess on
one device and comes back as host numpy.

``detection.device``: ``"auto"``/``"cuda"`` run on the card (and raise when
there is none), ``"cpu"`` on the CPU. Weights: a flat or path-keyed ``.npz``,
a HF ``.pt``/``.bin``/``.safetensors``, otherwise a seeded random init with a
warning. ``detect_with_features``, ``extract_features`` and
``get_attention_map`` wait for a later slice; the data-parallel mesh and the
I420 transfer formats have no counterpart on one card.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..core.dto import Detection, DetectionBatch
from ..device import resolve_device
from ..models.detr import DETR, DETRConfig
from ..models.postprocess import postprocess_detr
from ..models.weights import load_checkpoint
from ..ops.preprocessing import preprocess_frames

logger = logging.getLogger(__name__)

#: Seed of the random init when no checkpoint is given.
INIT_SEED = 0


def _host_merge(chunks: list[DetectionBatch], n: int) -> DetectionBatch:
    """Concatenate per-chunk results and strip the padded frames."""
    fields = {
        name: np.concatenate([getattr(c, name) for c in chunks])[:n]
        for name in ("boxes_xywh", "scores", "valid", "foot")
    }
    return DetectionBatch(**fields)


class DETRDetector:
    """Batched DETR person detector on one device."""

    def __init__(self, config: Any = None, *, detr_config: DETRConfig | None = None):
        get = (lambda k, d: config.get(k, d)) if config is not None else (lambda k, d: d)
        self.confidence_threshold = float(get("detection.confidence_threshold", 0.5))
        self.batch_size = int(get("detection.batch_size", 4))
        self.input_hw = (
            int(get("detection.input_height", 736)),
            int(get("detection.input_width", 1280)),
        )
        self.checkpoint_path = get("detection.checkpoint_path", None)
        _nms = get("detection.nms_threshold", None)
        self.nms_threshold = float(_nms) if _nms is not None else None
        self.device_pref = str(get("detection.device", "auto"))
        if detr_config is None:
            if str(get("detection.backbone", "resnet50")) != "resnet50":
                raise NotImplementedError("only the resnet50 backbone is ported")
            common = dict(
                num_queries=int(get("detection.num_queries", 100)),
                dtype=str(get("detection.dtype", "bfloat16")),
                use_pallas_attention=bool(get("detection.use_pallas_attention", False)),
                dilate_c5=bool(get("detection.dilate_c5", False)),
                score_mode=str(get("detection.score_mode", "softmax")),
            )
            model_size = str(get("detection.model_size", "full"))
            if model_size in ("tiny", "small"):
                # The tier fixes its own query count unless one is configured
                # explicitly (anything but the schema default of 100).
                requested_q = common.pop("num_queries")
                if requested_q != 100:
                    common["num_queries"] = requested_q
                    logger.warning(
                        "detection.num_queries=%d overrides the %s tier's default query count",
                        requested_q, model_size,
                    )
                detr_config = getattr(DETRConfig, model_size)(**common)
            else:
                detr_config = DETRConfig(**common)
        self.detr_config = detr_config
        self.device: torch.device | None = None
        self.model: DETR | None = None

    # ------------------------------------------------------------------ load
    def load_model(self) -> None:
        """Resolve the device, build the CUDA kernels (on the card), and load
        the weights: checkpoint file -> seeded random init with a warning."""
        self.device = resolve_device(self.device_pref, self.detr_config.dtype)
        if self.device.type == "cuda":
            from ..kernels import attention as attention_kernels

            attention_kernels.load_library()
        model = DETR(self.detr_config)
        ckpt = self.checkpoint_path
        if ckpt and Path(str(ckpt)).exists():
            model.load_state_dict(load_checkpoint(ckpt, self.detr_config))
            logger.info("loaded checkpoint from %s", ckpt)
        else:
            if ckpt:
                logger.warning("checkpoint %s not found; using random init", ckpt)
            else:
                logger.warning("no checkpoint configured; using random init (seed %d)", INIT_SEED)
            model.init_weights(torch.Generator().manual_seed(INIT_SEED))
        self.model = model.to(device=self.device, dtype=self.detr_config.torch_dtype).eval()

    def _bucket_sizes(self) -> list[int]:
        """Chunk sizes up to batch_size: powers of two, then batch_size."""
        sizes = []
        b = 1
        while b < self.batch_size:
            sizes.append(b)
            b *= 2
        sizes.append(self.batch_size)
        return sizes

    def _tail_bucket(self, remainder: int) -> int:
        """Smallest chunk size that holds a partial tail of frames."""
        for b in self._bucket_sizes():
            if b >= remainder:
                return b
        return self.batch_size

    def _empty_chunk(self, n: int) -> DetectionBatch:
        """All-invalid results for a failed chunk of n frames."""
        q = self.detr_config.num_queries
        return DetectionBatch(
            boxes_xywh=np.zeros((n, q, 4), np.float32),
            scores=np.zeros((n, q), np.float32),
            valid=np.zeros((n, q), bool),
            foot=np.zeros((n, q, 2), np.float32),
        )

    @torch.inference_mode()
    def _detect_chunk(self, frames_u8: np.ndarray, orig_wh: tuple[int, int]) -> DetectionBatch:
        frames = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(self.device)
        pixels, mask = preprocess_frames(
            frames, target_hw=self.input_hw, out_dtype=self.detr_config.torch_dtype
        )
        out = self.model(pixels, mask)
        return postprocess_detr(
            out["logits"], out["boxes"], orig_wh, self.confidence_threshold,
            person_class_id=self.detr_config.person_class_id,
            score_mode=self.detr_config.score_mode,
            nms_iou=self.nms_threshold,
        )

    # ---------------------------------------------------------------- detect
    def detect_batch(self, frames: np.ndarray) -> DetectionBatch:
        """(F, H, W, 3) uint8 BGR -> DetectionBatch (F, Q) of host arrays.
        A partial tail is padded to a bucket size; callers see F frames."""
        if self.model is None:
            self.load_model()
        F, H, W, _ = frames.shape
        tail = F % self.batch_size
        pad = (self._tail_bucket(tail) - tail) if tail else 0
        if pad:
            frames = np.concatenate([frames, np.zeros((pad, H, W, 3), np.uint8)])
        chunks = []
        for i in range(0, len(frames), self.batch_size):
            chunk = frames[i : i + self.batch_size]
            try:
                batch = self._detect_chunk(chunk, (W, H))
            except Exception:
                # Per-chunk failure isolation (the reference's per-frame
                # analog): a failed chunk logs and yields all-invalid results
                # for its frames instead of aborting the whole phase.
                logger.exception(
                    "detect chunk failed for frames [%d, %d); continuing with empty "
                    "results for those frames", i, i + len(chunk),
                )
                batch = self._empty_chunk(len(chunk))
            chunks.append(batch)
        return _host_merge(chunks, F)

    def detect(self, frame: np.ndarray) -> list[Detection]:
        return self.detect_batch(frame[None]).to_frame_results()[0].detections

    def cleanup(self) -> None:
        self.model = None
