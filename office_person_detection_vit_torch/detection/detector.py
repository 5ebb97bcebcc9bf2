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
warning.

``parallel.mesh.{data,model}`` (JAX ``detector.py:95-96, 216-250``): the
ranks of a running process group (one card each, ``torchrun``) form a
(data, model) grid (``data: -1`` all of them); every rank calls
``detect_batch`` with the same frames, detects its slice of each chunk and
gathers the whole chunk's results (``parallel/inference.py``), and
``model`` above 1 splits the transformer over the model ranks. One process
has no mesh. With a mesh ``auto`` races ``bgr`` and ``i420`` only, and
``i420d`` runs as ``i420`` (its chain runs along the frame axis).

``detection.transfer_format`` (JAX ``detector.py:77-87, 283-404``): ``bgr``
uploads the uint8 BGR frames; ``i420`` converts them on the host to I420
(``ops/staging.py``, 1.5 bytes a pixel instead of 3) and decodes on the
device (``ops/preprocessing.py::preprocess_frames_i420``); ``i420d`` also
XORs each chunk's frames with their predecessors on the host, the previous
chunk's last frame chaining the chunks, and undoes it on the device against
that frame, which stays on the device (``reconstruct_i420_delta``): the same
pixels as ``i420``, bit for bit. ``auto`` races the three on the first batch
(interleaved best of 3, each call ending in the host fetch of its results)
and keeps the winner, which ``detection_statistics.json`` records. A frame
whose H % 4 or W % 2 is not 0 takes ``bgr``, with a warning, as in JAX.
The value is matched exactly, as the JAX detector matches it; a value that
names no route (``I420`` among them) raises.
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
from ..ops import staging
from ..ops.preprocessing import (compute_resize_geometry, preprocess_frames, preprocess_frames_i420,
                                 reconstruct_i420_delta)
from .features import crop_histogram_features, roi_mean_pool

logger = logging.getLogger(__name__)

#: Seed of the random init when no checkpoint is given.
INIT_SEED = 0


#: The upload formats ``auto`` races, in the order it tries them.
TRANSFER_FORMATS = ("bgr", "i420", "i420d")


def check_transfer_format(value: Any) -> str:
    """``detection.transfer_format`` as written: one of
    :data:`TRANSFER_FORMATS` or ``auto``; anything else (another case too)
    raises."""
    fmt = str(value)
    if fmt != "auto" and fmt not in TRANSFER_FORMATS:
        raise ValueError(f"detection.transfer_format={value!r}: expected bgr, i420, i420d or auto")
    return fmt


def _host_merge(chunks: list[DetectionBatch], n: int) -> DetectionBatch:
    """Concatenate per-chunk results and strip the padded frames."""
    fields = {
        name: np.concatenate([getattr(c, name) for c in chunks])[:n]
        for name in ("boxes_xywh", "scores", "valid", "foot")
    }
    return DetectionBatch(**fields)


class DETRDetector:
    """Batched DETR person detector on one device."""

    #: How frames go up to the device: ``bgr``, ``i420``, ``i420d``, or
    #: ``auto`` until the first batch's race replaces it with the winner.
    #: ``detection_statistics.json`` records it.
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
        self.data_parallel = int(get("parallel.mesh.data", -1))
        self.model_parallel = int(get("parallel.mesh.model", 1))
        self.mesh = None
        self._data_size = 1
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
        #: best ms a chunk of each format in the ``auto`` race, once it ran
        self.transfer_race_ms: dict[str, float] | None = None
        # i420d's chain: the last I420 frame sent (host) and its device copy.
        self._delta_prev_host: np.ndarray | None = None
        self._delta_prev_dev: torch.Tensor | None = None

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
        self._setup_mesh()
        if self.mesh is not None:
            from ..parallel.inference import detect_shardings

            model, self._place_frames = detect_shardings(model, self.mesh, tensor_parallel=self.model_parallel > 1)
        self.model = model.to(device=self.device, dtype=self.detr_config.torch_dtype).eval()

    def _setup_mesh(self) -> None:
        """The (data, model) grid of ``parallel.mesh.*`` (see module doc;
        ``parallel.mesh.detect_mesh``), and with a mesh ``i420d`` runs as
        ``i420``."""
        from ..parallel.mesh import detect_mesh

        self.mesh, self._data_size, self.batch_size = detect_mesh(self.data_parallel, self.model_parallel,
                                                                  self.batch_size)
        if self.mesh is not None and self.transfer_format == "i420d":
            logger.warning("i420d transfer is single-device; using i420")
            self.transfer_format = "i420"

    def _bucket_sizes(self) -> list[int]:
        """Chunk sizes up to batch_size: powers of two (times the data
        axis, so that every chunk splits over it), then batch_size."""
        sizes = []
        b = self._data_size
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

    def _upload(self, payload: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(payload)).to(self.device)

    def _pixels(self, payload: np.ndarray, fmt: str = "bgr") -> tuple[torch.Tensor, torch.Tensor]:
        """A chunk's payload (BGR frames, or I420 planes for the I420 routes)
        -> the model's pixels and mask on the device. ``i420d`` XORs the
        planes with their predecessors here, uploads the deltas and undoes
        them on the device against the chain's last frame."""
        dtype = self.detr_config.torch_dtype
        if fmt == "bgr":
            return preprocess_frames(self._upload(payload), target_hw=self.input_hw, out_dtype=dtype)
        if fmt == "i420d":
            if self._delta_prev_host is None or self._delta_prev_host.shape != payload.shape[1:]:
                # The first chunk (or a new frame size): a zero seed.
                self._delta_prev_host = np.zeros(payload.shape[1:], np.uint8)
                self._delta_prev_dev = self._upload(self._delta_prev_host)
            deltas = staging.i420_delta_encode(payload, self._delta_prev_host)
            planes = reconstruct_i420_delta(self._upload(deltas), self._delta_prev_dev)
            self._delta_prev_host = payload[-1].copy()
            self._delta_prev_dev = planes[-1].clone()  # not a view that keeps the chunk
        else:
            planes = self._upload(payload)
        return preprocess_frames_i420(planes, target_hw=self.input_hw, out_dtype=dtype)

    def _detect_chunk(self, payload: np.ndarray, orig_wh: tuple[int, int]) -> tuple[DetectionBatch, torch.Tensor]:
        """One chunk on the route of ``transfer_format`` (resolved)."""
        return self._run_chunk(payload, orig_wh, self.transfer_format)

    @torch.inference_mode()
    def _run_chunk(self, payload: np.ndarray, orig_wh: tuple[int, int],
                   fmt: str) -> tuple[DetectionBatch, torch.Tensor]:
        if self.mesh is not None:  # this rank's slice of the chunk
            payload = self._place_frames(payload)
        out = self.model(*self._pixels(payload, fmt))
        batch = postprocess_detr(
            out["logits"], out["boxes"], orig_wh, self.confidence_threshold,
            person_class_id=self.detr_config.person_class_id,
            score_mode=self.detr_config.score_mode,
            nms_iou=self.nms_threshold,
        )
        if self.mesh is not None:
            from ..parallel.inference import gather_detections

            return gather_detections(batch, self.mesh, out["encoder_output"])
        return batch, out["encoder_output"]

    def _autotune_transfer(self, frames: np.ndarray) -> str:
        """Race :data:`TRANSFER_FORMATS` on the first batch (already padded to a
        bucket) and return the fastest, as JAX's ``_autotune_transfer``: each
        format once to warm it, then 3 interleaved rounds, each call timed on
        the host clock up to the host fetch of its results (which waits for
        the card); the best of each format's 3 wins. Each I420 route is
        timed with its host conversion (and ``i420d`` its delta), which
        detect_batch pays too; JAX converts the sample once before its race
        and times only the delta."""
        sample = frames[: self.batch_size]
        _, H, W, _ = sample.shape
        payloads = {"bgr": lambda: sample, "i420": lambda: staging.bgr_to_i420(sample),
                    "i420d": lambda: staging.bgr_to_i420(sample)}
        # A mesh races bgr and i420 only: i420d's chain is single-device (JAX :361).
        formats = TRANSFER_FORMATS if self.mesh is None else ("bgr", "i420")
        best = {fmt: float("inf") for fmt in formats}
        for fmt in formats:  # warm each
            self._run_chunk(payloads[fmt](), (W, H), fmt)
        for _ in range(3):
            for fmt in formats:
                t0 = time.perf_counter()
                self._run_chunk(payloads[fmt](), (W, H), fmt)
                best[fmt] = min(best[fmt], time.perf_counter() - t0)
        winner = min(best, key=best.get)
        self.transfer_race_ms = {fmt: 1e3 * t for fmt, t in best.items()}
        logger.info("transfer autotune: %s (%s per batch)", winner,
                    ", ".join(f"{fmt} {1e3 * t:.1f} ms" for fmt, t in best.items()))
        return winner

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
        if self.transfer_format != "bgr" and (H % 4 or W % 2):
            logger.warning("i420 transfer unsupported for %dx%d (H%%4/W%%2); using bgr", H, W)
            self.transfer_format = "bgr"
        if self.transfer_format == "auto":
            self.transfer_format = self._autotune_transfer(frames)
        fmt = self.transfer_format
        if fmt != "bgr":
            frames = staging.bgr_to_i420(frames)  # (F, H*3/2, W): half the bytes
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
