"""DETRDetector: batched DETR person detection.

Mirrors ``office_person_detection_vit_tpu/detection/detector.py``: the same
constructor (any config with ``.get(dotted_key, default)``: the JAX
package's ``ConfigManager``, or a plain dict of dotted keys),
``load_model``, ``detect_batch``, ``detect``, ``detect_with_features``,
``extract_features``, ``get_attention_map`` and ``cleanup``; power-of-two
tail buckets, per-chunk failure isolation and ``detection.nms_threshold`` as
the JAX detector reads them. A chunk runs preprocess -> DETR -> postprocess on
one device and comes back as host numpy; its encoder output stays on the
device for the appearance features.

``detection.backbone``: ``resnet50`` or ``vit`` (ViT-base/16 at full size,
the patch from ``detection.patch_size``; the tiny ViT in the tiny and small
tiers). ``detection.device``: ``"auto"``/``"cuda"`` run on the card (and raise when
there is none), ``"cpu"`` on the CPU. Weights: a flat or path-keyed ``.npz``,
a HF ``.pt``/``.bin``/``.safetensors``, otherwise a seeded random init with a
warning. The data-parallel mesh has no counterpart on one card;
``detection.transfer_format`` ``i420``/``i420d`` raise until ROADMAP A.4, and
``auto`` resolves to ``bgr``.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..core.dto import Detection, DetectionBatch
from ..device import resolve_device
from ..models.detr import DETR, DETRConfig
from ..models.postprocess import postprocess_detr
from ..models.vit import ViTConfig
from ..models.weights import load_checkpoint
from ..ops.preprocessing import compute_resize_geometry, preprocess_frames
from .features import crop_histogram_features, roi_mean_pool

logger = logging.getLogger(__name__)

#: Seed of the random init when no checkpoint is given.
INIT_SEED = 0


def check_transfer_format(value: Any) -> str:
    """The upload format ``detection.transfer_format`` comes to: ``bgr``.

    ``auto`` (the JAX detector races ``bgr``, ``i420`` and ``i420d`` on the
    first batch) resolves to ``bgr``, one of the race's candidates, and says
    so in the log; ``i420`` and ``i420d`` raise until the I420 routes are
    ported (ROADMAP A.4): their chroma subsampling changes the pixels the
    model sees.
    """
    fmt = str(value).lower()
    if fmt in ("i420", "i420d"):
        raise NotImplementedError(
            f"detection.transfer_format={fmt!r}: the I420 transfer routes are not ported yet (ROADMAP A.4)")
    if fmt == "auto":
        logger.info("detection.transfer_format 'auto' resolves to 'bgr' (one of the race's candidates; the I420 "
                    "routes wait for ROADMAP A.4)")
    elif fmt != "bgr":
        raise ValueError(f"detection.transfer_format={value!r}: expected bgr, i420, i420d or auto")
    return "bgr"


def _host_merge(chunks: list[DetectionBatch], n: int) -> DetectionBatch:
    """Concatenate per-chunk results and strip the padded frames."""
    fields = {
        name: np.concatenate([getattr(c, name) for c in chunks])[:n]
        for name in ("boxes_xywh", "scores", "valid", "foot")
    }
    return DetectionBatch(**fields)


class DETRDetector:
    """Batched DETR person detector on one device."""

    #: How frames go up to the device: BGR uint8 (the I420 routes wait for
    #: ROADMAP A.4; ``check_transfer_format``). ``detection_statistics.json``
    #: records it.
    transfer_format = "bgr"

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
        self.transfer_format = check_transfer_format(get("detection.transfer_format", "bgr"))
        if detr_config is None:
            common = dict(
                num_queries=int(get("detection.num_queries", 100)),
                dtype=str(get("detection.dtype", "bfloat16")),
                use_pallas_attention=bool(get("detection.use_pallas_attention", False)),
                dilate_c5=bool(get("detection.dilate_c5", False)),
                score_mode=str(get("detection.score_mode", "softmax")),
            )
            # detection.backbone: "vit" with the patch of detection.patch_size;
            # any other value is the ResNet, as in JAX.
            backbone = str(get("detection.backbone", "resnet50"))
            if backbone == "vit":
                common.update(backbone="vit", vit_patch_size=int(get("detection.patch_size", 16)))
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
                if backbone == "vit":  # the tiny ViT's widths in both small tiers, as in JAX
                    t = ViTConfig.tiny()
                    common.update(vit_patch_size=int(get("detection.patch_size", t.patch_size)),
                                  vit_hidden=t.hidden_size, vit_layers=t.num_layers, vit_heads=t.num_heads,
                                  vit_mlp=t.mlp_dim, vit_pos_grid=t.pos_grid)
                detr_config = getattr(DETRConfig, model_size)(**common)
            else:
                detr_config = DETRConfig(**common)
        self.detr_config = detr_config
        #: pixels of the input per feature-grid cell (ROI pooling, attention
        #: maps): the ViT's patch, or the ResNet's 32 (16 with DC5)
        self.feature_stride = detr_config.feature_stride
        self.device: torch.device | None = None
        self.model: DETR | None = None
        #: host seconds of the last detect_batch's chunk loop
        self.last_inference_time = 0.0
        #: chunks of the last detect_batch that raised and came back all-invalid
        self.last_failed_chunks = 0
        # What the last detect_batch keeps for the features: each chunk's
        # encoder output (on the device), the frame count and size.
        self._last_encoder_chunks: list[torch.Tensor] = []
        self._last_encoder_output: torch.Tensor | None = None
        self._last_frame_count = 0
        self._last_orig_wh = (0, 0)

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

    @property
    def feature_hw(self) -> tuple[int, int]:
        return self.input_hw[0] // self.feature_stride, self.input_hw[1] // self.feature_stride

    def _empty_chunk(self, n: int) -> tuple[DetectionBatch, torch.Tensor]:
        """All-invalid results and zero encoder features for a failed chunk
        of n frames (their pooled features are then zeros)."""
        q = self.detr_config.num_queries
        fh, fw = self.feature_hw
        batch = DetectionBatch(
            boxes_xywh=np.zeros((n, q, 4), np.float32),
            scores=np.zeros((n, q), np.float32),
            valid=np.zeros((n, q), bool),
            foot=np.zeros((n, q, 2), np.float32),
        )
        return batch, torch.zeros((n, fh * fw, self.detr_config.d_model), dtype=self.detr_config.torch_dtype,
                                  device=self.device)

    def _pixels(self, frames_u8: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        frames = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(self.device)
        return preprocess_frames(frames, target_hw=self.input_hw, out_dtype=self.detr_config.torch_dtype)

    @torch.inference_mode()
    def _detect_chunk(self, frames_u8: np.ndarray, orig_wh: tuple[int, int]) -> tuple[DetectionBatch, torch.Tensor]:
        out = self.model(*self._pixels(frames_u8))
        batch = postprocess_detr(
            out["logits"], out["boxes"], orig_wh, self.confidence_threshold,
            person_class_id=self.detr_config.person_class_id,
            score_mode=self.detr_config.score_mode,
            nms_iou=self.nms_threshold,
        )
        return batch, out["encoder_output"]

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
        t0 = time.perf_counter()
        chunks, encs = [], []
        self.last_failed_chunks = 0
        for i in range(0, len(frames), self.batch_size):
            chunk = frames[i : i + self.batch_size]
            try:
                batch, enc = self._detect_chunk(chunk, (W, H))
            except Exception:
                # Per-chunk failure isolation (the reference's per-frame
                # analog): a failed chunk logs and yields all-invalid results
                # for its frames instead of aborting the whole phase.
                logger.exception(
                    "detect chunk failed for frames [%d, %d); continuing with empty "
                    "results for those frames", i, i + len(chunk),
                )
                batch, enc = self._empty_chunk(len(chunk))
                self.last_failed_chunks += 1
            chunks.append(batch)
            encs.append(enc)
        self.last_inference_time = time.perf_counter() - t0
        self._last_encoder_chunks = encs
        self._last_encoder_output = None  # concatenated when features are asked for
        self._last_frame_count = F
        self._last_orig_wh = (W, H)
        return _host_merge(chunks, F)

    def detect(self, frame: np.ndarray) -> list[Detection]:
        return self.detect_batch(frame[None]).to_frame_results()[0].detections

    def detect_with_features(self, frame: np.ndarray) -> tuple[list[Detection], np.ndarray]:
        """Detections and their 256-d L2-normalised appearance features (ROI
        means of the encoder output), one per valid detection."""
        batch = self.detect_batch(frame[None])
        feats = self._pool_features(batch).cpu().numpy()
        dets = batch.to_frame_results()[0].detections
        feat_np = feats[0][batch.valid[0]]
        for det, f in zip(dets, feat_np):
            det.feature = f
        return dets, feat_np

    @torch.inference_mode()
    def _pool_features(self, batch: DetectionBatch) -> torch.Tensor:
        """(F, Q, C) features of the last detect_batch's boxes, on the device."""
        W, H = self._last_orig_wh
        if self._last_encoder_output is None:
            self._last_encoder_output = torch.cat(self._last_encoder_chunks)[: self._last_frame_count]
        # The valid (not padded) part of the feature grid holds the resized
        # image: scale original pixels into it.
        rh, rw = compute_resize_geometry((H, W), self.input_hw)
        eff_wh = [W * (self.input_hw[1] / rw), H * (self.input_hw[0] / rh)]
        dev = self.device
        return roi_mean_pool(
            self._last_encoder_output, self.feature_hw,
            torch.from_numpy(batch.boxes_xywh).to(dev), torch.from_numpy(batch.valid).to(dev),
            torch.tensor(eff_wh, dtype=torch.float32, device=dev),
        )

    def extract_features(self, frame: np.ndarray, bboxes: list[tuple[float, float, float, float]]) -> np.ndarray:
        """Features of boxes given from outside (crop histograms, host)."""
        return crop_histogram_features(frame, np.asarray(bboxes, np.float32))

    # ------------------------------------------------------------- attention
    @torch.inference_mode()
    def get_attention_map(self, frame: np.ndarray) -> np.ndarray:
        """The last decoder layer's cross-attention probabilities, averaged
        over heads and queries -> (fh, fw) float32 heat map.

        The kernels never form the probabilities, so this one call of the
        last layer's cross-attention runs the plain version
        (``attention_reference(return_probs=True)``); every other attention
        call of the forward pass, and every detect_batch, is unchanged.
        """
        if self.model is None:
            self.load_model()
        attn = getattr(self.model.decoder, f"layer_{self.detr_config.num_decoder_layers - 1}").encoder_attn
        attn.kept_probs = []
        try:
            self.model(*self._pixels(frame[None]))
            probs = attn.kept_probs[0]  # (B, heads, Q, L)
        finally:
            attn.kept_probs = None
        fh, fw = self.feature_hw
        return probs[0].float().mean(dim=(0, 1)).reshape(fh, fw).cpu().numpy()

    def cleanup(self) -> None:
        self.model = None
        self._last_encoder_chunks = []
        self._last_encoder_output = None
