"""SSDDetector: the single-shot anchor-free detector behind the DETR
detector's interface, and ``build_detector``.

Mirrors ``office_person_detection_vit_tpu/detection/ssd_detector.py:32-227``:
the constructor (any config with ``.get(dotted_key, default)``),
``load_model``, ``detect_batch``, ``detect``, ``detect_with_features`` (crop
histograms on the host: a conv detector has no encoder features to pool),
``extract_features``, ``get_attention_map`` (``None``: no attention) and
``cleanup``, with the hooks the YOLOv8 facade overrides
(``detection/yolo_detector.py``). A chunk runs preprocess -> model -> decode
on one device (``detection.device``, the card unless ``"cpu"``), tail chunks
are padded to a power-of-two bucket as the DETR detector pads them, and a
chunk that raises comes back all-invalid. Frames go up as BGR uint8 (the JAX
facade has no I420 route). Weights: a flat or path-keyed ``.npz``; a missing
path warns and takes a seeded init. The JAX data-parallel mesh has no
counterpart on one card.
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
from ..models.single_shot import SingleShotConfig, SingleShotDetector, decode_single_shot
from ..models.weights import load_checkpoint
from ..ops.preprocessing import preprocess_frames
from .detector import INIT_SEED, _host_merge
from .features import crop_histogram_features

logger = logging.getLogger(__name__)


class SSDDetector:
    """Anchor-free single-shot person detector (the DETR detector's API)."""

    #: checkpoint suffixes this family loads (others warn and init)
    checkpoint_suffixes = (".npz",)

    def __init__(self, config: Any = None, *, ss_config: SingleShotConfig | None = None):
        get = (lambda k, d: config.get(k, d)) if config is not None else (lambda k, d: d)
        self.confidence_threshold = float(get("detection.confidence_threshold", 0.5))
        self.batch_size = int(get("detection.batch_size", 8))
        self.input_hw = (
            int(get("detection.input_height", 736)),
            int(get("detection.input_width", 1280)),
        )
        self.checkpoint_path = get("detection.checkpoint_path", None)
        self.device_pref = str(get("detection.device", "auto"))
        #: the data-parallel grid (the DETR detector's ``parallel.mesh.data``
        #: contract; no tensor parallelism: no rule matches a convolution)
        self.data_parallel = int(get("parallel.mesh.data", -1))
        self.mesh = None
        self._data_size = 1
        #: the model's configuration (``SingleShotConfig``, or ``YOLOConfig``
        #: in the YOLOv8 facade), from ``detection.*`` unless given
        self.model_config = ss_config if ss_config is not None else self._config_from(get)
        self.device: torch.device | None = None
        self.model: torch.nn.Module | None = None
        #: host seconds of the last detect_batch's chunk loop
        self.last_inference_time = 0.0
        #: chunks of the last detect_batch that raised and came back all-invalid
        self.last_failed_chunks = 0

    # Hooks the YOLOv8 facade overrides ----------------------------------
    @staticmethod
    def _config_from(get) -> SingleShotConfig:
        """``detection.model_size: tiny`` the test-scale config, else the full
        one, with ``detection.dtype`` and ``detection.nms_threshold``."""
        nms = float(get("detection.nms_threshold", 0.45))
        if str(get("detection.model_size", "full")) == "tiny":
            return SingleShotConfig.tiny(nms_iou_threshold=nms)
        return SingleShotConfig(dtype=str(get("detection.dtype", "bfloat16")), nms_iou_threshold=nms)

    def _make_model(self) -> torch.nn.Module:
        return SingleShotDetector(self.model_config)

    def _decode(self, out: dict, orig_wh, conf=None, host: bool = True) -> DetectionBatch:
        """Raw outputs -> detections at ``conf`` (default: the configured
        threshold); ``host=False`` the device tensors (the exported program)."""
        conf = self.confidence_threshold if conf is None else conf
        return decode_single_shot(out, orig_wh, self.input_hw, self.model_config, conf, host)

    def _decode_tensors(self, out: dict, orig_wh, conf) -> dict:
        return self._decode(out, orig_wh, conf, host=False)

    # ------------------------------------------------------------------ load
    def load_model(self) -> None:
        """Resolve the device and load the weights: a checkpoint file of this
        family, else a seeded random init with a warning."""
        cfg = self.model_config
        self.device = resolve_device(self.device_pref, cfg.dtype)
        model = self._make_model()
        ckpt = self.checkpoint_path
        p = Path(str(ckpt)) if ckpt else None
        if p is not None and p.is_file() and p.suffix in self.checkpoint_suffixes:
            model.load_state_dict(load_checkpoint(p, cfg))
            logger.info("loaded checkpoint from %s", ckpt)
        else:
            if ckpt:
                logger.warning("checkpoint %s not found; using random init", ckpt)
            else:
                logger.warning("no checkpoint configured; using random init (seed %d)", INIT_SEED)
            model.init_weights(torch.Generator().manual_seed(INIT_SEED))
        self._setup_mesh()
        self.model = model.to(device=self.device, dtype=cfg.torch_dtype).eval()

    def _setup_mesh(self) -> None:
        from ..parallel.mesh import detect_mesh

        self.mesh, self._data_size, self.batch_size = detect_mesh(self.data_parallel, 1, self.batch_size)

    def _tail_bucket(self, remainder: int) -> int:
        """Smallest power of two (times the data axis; or batch_size) that
        holds a partial tail."""
        b = self._data_size
        while b < remainder:
            b *= 2
        return min(b, self.batch_size)

    def _empty_chunk(self, n: int) -> DetectionBatch:
        k = self.model_config.max_detections
        return DetectionBatch(boxes_xywh=np.zeros((n, k, 4), np.float32), scores=np.zeros((n, k), np.float32),
                              valid=np.zeros((n, k), bool), foot=np.zeros((n, k, 2), np.float32))

    @torch.inference_mode()
    def _detect_chunk(self, frames_u8: np.ndarray, orig_wh: tuple[int, int]) -> DetectionBatch:
        if self.mesh is not None:  # this rank's slice of the chunk
            from ..parallel.mesh import batch_slice

            frames_u8 = batch_slice(frames_u8, self.mesh.data_index, self.mesh.data_parallel)
        frames = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(self.device)
        pixels, _ = preprocess_frames(frames, target_hw=self.input_hw, out_dtype=self.model_config.torch_dtype)
        batch = self._decode(self.model(pixels), orig_wh)
        if self.mesh is not None:
            from ..parallel.inference import gather_detections

            batch = gather_detections(batch, self.mesh)[0]
        return batch

    # ---------------------------------------------------------------- detect
    def detect_batch(self, frames: np.ndarray) -> DetectionBatch:
        """(F, H, W, 3) uint8 BGR -> DetectionBatch (F, max_detections) of
        host arrays."""
        if self.model is None:
            self.load_model()
        F, H, W, _ = frames.shape
        tail = F % self.batch_size
        pad = (self._tail_bucket(tail) - tail) if tail else 0
        if pad:
            frames = np.concatenate([frames, np.zeros((pad, H, W, 3), np.uint8)])
        t0 = time.perf_counter()
        chunks = []
        self.last_failed_chunks = 0
        for i in range(0, len(frames), self.batch_size):
            chunk = frames[i : i + self.batch_size]
            try:
                chunks.append(self._detect_chunk(chunk, (W, H)))
            except Exception:
                logger.exception("detect chunk failed for frames [%d, %d); continuing with empty results for "
                                 "those frames", i, i + len(chunk))
                chunks.append(self._empty_chunk(len(chunk)))
                self.last_failed_chunks += 1
        self.last_inference_time = time.perf_counter() - t0
        return _host_merge(chunks, F)

    def detect(self, frame: np.ndarray) -> list[Detection]:
        return self.detect_batch(frame[None]).to_frame_results()[0].detections

    def detect_with_features(self, frame: np.ndarray) -> tuple[list[Detection], np.ndarray]:
        """Detections and their crop-histogram features (host)."""
        dets = self.detect(frame)
        feats = crop_histogram_features(frame, np.asarray([d.bbox for d in dets], np.float32).reshape(-1, 4))
        for d, f in zip(dets, feats):
            d.feature = f
        return dets, feats

    def extract_features(self, frame: np.ndarray, bboxes) -> np.ndarray:
        return crop_histogram_features(frame, np.asarray(bboxes, np.float32))

    def get_attention_map(self, frame: np.ndarray) -> np.ndarray | None:
        """A conv detector has no attention: ``None``, as in JAX."""
        return None

    def cleanup(self) -> None:
        self.model = None


def build_detector(config: Any):
    """The detector ``detection.model`` names (JAX ``ssd_detector.py:215-227``):
    ``ssd``/``single_shot``/``fcos`` the single-shot detector,
    ``yolo``/``yolov8`` YOLOv8, anything else DETR."""
    model = str(config.get("detection.model", "detr")).lower()
    if model in ("ssd", "single_shot", "fcos"):
        return SSDDetector(config)
    if model in ("yolo", "yolov8"):
        from .yolo_detector import YOLODetector

        return YOLODetector(config)
    from .detector import DETRDetector

    return DETRDetector(config)
