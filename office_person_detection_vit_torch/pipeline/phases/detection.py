"""Phase 2: batched person detection.

Mirrors ``office_person_detection_vit_tpu/pipeline/phases/detection.py``:
every sampled frame goes through the detector ``detection.model`` names
(``detection/ssd_detector.py::build_detector``: DETR, the single-shot
detector or YOLOv8) in device batches, the detections are written into the
``FrameResult``s, and the phase writes ``detections.json`` and
``detection_statistics.json`` (the JAX package's keys; the DETR detector's
``transfer_format``, after an ``auto`` race the winner, whose times the
detector logs as JAX's does) and, with ``output.save_detection_images``, annotated
frames. ``output.save_attention_maps`` raises until the overlays are ported
(ROADMAP A.3).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

import numpy as np

from ...core.dto import DetectionBatch, FrameResult
from ...detection import build_detector
from ...utils.image_utils import save_detection_image
from ...utils.stats_utils import calculate_detection_statistics
from .base import BasePhase

class DetectionPhase(BasePhase):
    name = "02_detection"

    def __init__(self, config: Any, logger=None, detector: Any = None):
        super().__init__(config, logger)
        if config.get("output.save_attention_maps", False):
            raise NotImplementedError(
                "output.save_attention_maps: the attention-map overlays are not ported yet (ROADMAP A.3)"
            )
        self.detector = detector
        self.save_images = bool(config.get("output.save_detection_images", False))
        self.last_batch: DetectionBatch | None = None
        self.statistics: dict[str, Any] = {}

    def initialize(self) -> None:
        """Build the detector and load its weights."""
        if self.detector is None:
            self.detector = build_detector(self.config)
        if self.detector.model is None:
            self.detector.load_model()

    def execute(self, frames: list[np.ndarray], frame_results: list[FrameResult],
                output_dir: str | Path | None = None) -> list[FrameResult]:
        """Detect on every frame; ``frames[i]`` is the decoded image of
        ``frame_results[i]``, whose detections are filled in place."""
        self.log_banner()
        self.initialize()
        if not frames:
            self.statistics = calculate_detection_statistics(
                DetectionBatch(boxes_xywh=np.zeros((0, 1, 4), np.float32), scores=np.zeros((0, 1), np.float32),
                               valid=np.zeros((0, 1), bool), foot=np.zeros((0, 1, 2), np.float32))
            )
            return frame_results

        t0 = time.perf_counter()
        batch = self.detector.detect_batch(np.stack(frames))
        self.last_batch = batch
        per_frame = batch.to_frame_results(
            frame_numbers=[fr.frame_number for fr in frame_results],
            timestamps=[fr.timestamp for fr in frame_results],
        )
        elapsed = time.perf_counter() - t0  # the results are on the host
        self.logger.info("detected %d frames in %.3fs (%.1f frames/s)",
                         len(frames), elapsed, len(frames) / max(elapsed, 1e-9))
        for fr, det_fr in zip(frame_results, per_frame):
            fr.detections = det_fr.detections

        self.statistics = calculate_detection_statistics(batch)
        fmt = getattr(self.detector, "transfer_format", None)
        if fmt is not None:
            self.statistics["transfer_format"] = str(fmt)
        if output_dir is not None:
            out = Path(output_dir)
            self._export_statistics(out)
            self._export_detections(out, frame_results)
            if self.save_images:
                for fr, frame in zip(frame_results, frames):
                    save_detection_image(frame, fr.detections, out / f"detection_{fr.timestamp_stem}.jpg")
        self.log_statistics()
        return frame_results

    def _export_statistics(self, output_dir: Path) -> Path:
        output_dir.mkdir(parents=True, exist_ok=True)
        path = output_dir / "detection_statistics.json"
        path.write_text(json.dumps(self.statistics, indent=2), encoding="utf-8")
        return path

    def _export_detections(self, output_dir: Path, frame_results: list[FrameResult]) -> Path:
        """``detections.json``: every frame's raw detections."""
        output_dir.mkdir(parents=True, exist_ok=True)
        doc = {
            "frames": [
                {"frame_number": fr.frame_number, "timestamp": fr.timestamp_str,
                 "detections": [d.to_dict() for d in fr.detections]}
                for fr in frame_results
            ]
        }
        path = output_dir / "detections.json"
        path.write_text(json.dumps(doc), encoding="utf-8")
        return path

    def log_statistics(self) -> None:
        s = self.statistics
        if not s:
            return
        self.logger.info(
            "detections: %d total over %d frames (avg %.2f/frame, conf mean %.3f)",
            s["total_detections"], s["total_frames"], s["avg_detections_per_frame"], s["confidence"]["mean"],
        )

    def cleanup(self) -> None:
        if self.detector is not None:
            self.detector.cleanup()
