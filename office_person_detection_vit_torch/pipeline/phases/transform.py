"""Phase 3: floor coordinates and zones of every detection.

Mirrors ``office_person_detection_vit_tpu/pipeline/phases/transform.py``:
the transformer ``transform.method`` names (homography, piecewise_affine or
thin_plate_spline), lens undistortion where it is enabled, then one device
pass over every foot point of the run: (undistort) -> floormap pixels ->
millimetres -> zone membership, and one copy back to the host. It writes
``coordinate_transformations.json``, honouring ``output.json_optimization``
(compact keys, coordinate precision, leaving out the pixel coordinates).
Everything runs on ``detection.device``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

from ...calibration.lens_distortion import LensDistortionCorrector
from ...core.dto import FrameResult
from ...device import config_device
from ...transform.common import apply_floor_transform
from ...transform.floormap_config import FloorMapConfig
from ...transform.piecewise_affine import build_transformer
from ...zone.zone_classifier import ZoneClassifier
from .base import BasePhase


class TransformPhase(BasePhase):
    name = "04_transform"

    def __init__(self, config: Any, logger=None):
        super().__init__(config, logger)
        self.transformer = None
        self.zone_classifier: ZoneClassifier | None = None
        self.floormap = FloorMapConfig.from_config(config)
        self.undistorter: LensDistortionCorrector | None = None
        self.statistics: dict[str, Any] = {}

    def initialize(self) -> None:
        device = config_device(self.config)
        if self.config.get("transform.lens_distortion.enabled", False) or self.config.get(
            "calibration.use_distortion_correction", False
        ):
            self.undistorter = LensDistortionCorrector.from_config(self.config, device)
            if self.undistorter.params.is_identity:
                self.logger.info("lens distortion params are identity; disabled")
                self.undistorter = None
        if self.transformer is None:
            self.transformer = build_transformer(self.config, undistorter=self.undistorter)
        zones = self.config.get("zones", [])
        if zones and self.zone_classifier is None:
            self.zone_classifier = ZoneClassifier(
                zones, overlap_mode=str(self.config.get("zones_overlap_mode", "all")), device=device
            )

    # ------------------------------------------------------------------ run
    def execute(self, frame_results: list[FrameResult], output_dir: str | Path | None = None) -> list[FrameResult]:
        """Fill floor_coords_px, floor_coords_mm and zone_ids of every detection."""
        self.log_banner()
        self.initialize()
        dets = [det for fr in frame_results for det in fr.detections]
        apply_floor_transform(self.transformer, dets, self.floormap, self.zone_classifier)
        if self.zone_classifier is None:
            for det in dets:
                det.zone_ids = []

        self.statistics = self._compute_statistics(frame_results, len(dets))
        self.log_statistics()
        if output_dir is not None:
            self.export_results(frame_results, Path(output_dir))
        return frame_results

    def _compute_statistics(self, frame_results: list[FrameResult], total: int) -> dict[str, Any]:
        classified = sum(1 for fr in frame_results for d in fr.detections if d.zone_ids)
        return {
            "total_detections": total,
            "transformed": total,
            "zone_classified": classified,
            "unclassified": total - classified,
            "method": str(self.config.get("transform.method", "homography")),
        }

    def log_statistics(self) -> None:
        s = self.statistics
        self.logger.info("transformed %d detections (%s); %d zone-classified, %d unclassified",
                         s["total_detections"], s["method"], s["zone_classified"], s["unclassified"])

    # -------------------------------------------------------------- export
    def export_results(self, frame_results: list[FrameResult], output_dir: Path) -> Path:
        """``coordinate_transformations.json``. ``output.json_optimization``:
        ``enabled`` gates the rest; ``coordinate_precision`` rounds;
        ``compact_keys`` writes the compact form; ``exclude_px_coords``
        leaves out the floormap pixels."""
        output_dir.mkdir(parents=True, exist_ok=True)
        opt = self.config.get("output.json_optimization", {}) or {}
        enabled = bool(opt.get("enabled", False))
        precision = int(opt.get("coordinate_precision", 1)) if enabled else None
        compact = bool(opt.get("compact_keys", False)) and enabled
        exclude_px = bool(opt.get("exclude_px_coords", False)) and enabled

        frames_out = []
        for fr in frame_results:
            if compact:
                frames_out.append({
                    "idx": fr.frame_number,
                    "ts": fr.timestamp_str,
                    "det": [d.to_compact_dict(precision=precision, exclude_px=exclude_px) for d in fr.detections],
                })
                continue
            dets = []
            for d in fr.detections:
                doc = d.to_dict(precision=precision)
                if exclude_px:
                    doc.pop("floor_coords_px", None)
                dets.append(doc)
            frames_out.append({"frame_number": fr.frame_number, "timestamp": fr.timestamp_str, "detections": dets})
        doc = {
            "transform_method": str(self.config.get("transform.method", "homography")),
            "transformer_info": self.transformer.get_info(),
            "frames": frames_out,
        }
        path = output_dir / "coordinate_transformations.json"
        path.write_text(
            json.dumps(doc, indent=None if compact else 2, separators=(",", ":") if compact else None),
            encoding="utf-8",
        )
        return path
