"""Pipeline orchestration (reference src/pipeline/orchestrator.py:28-454).

Mirrors ``office_person_detection_vit_tpu/pipeline/orchestrator.py`` over the
port's own phases: session setup, per-phase time (``performance`` of
``summary.json``; each scope synchronises the card), checkpoints after each
phase, the session summary, and resume: ``run(resume_session=...)`` skips
completed phases by reloading their artifacts.

What the port does not have yet is refused when the orchestrator is built,
before any session directory is written (:func:`refuse_unported`), and so is
a card that is asked for and missing (``device.resolve_device``). Tracking
(Phase 2.5) is off by default, and then writes the same ``skipped``
checkpoint as in JAX; with ``tracking.enabled`` it shares Phase 2's
detector, and with ``video.dense_tracking.enabled`` it turns the dense frames
into output windows before Phase 3.
"""

from __future__ import annotations

import json
import logging
from datetime import datetime
from pathlib import Path
from typing import Any

import numpy as np

from ..core.dto import AggregationResult, Detection, FrameResult
from ..detection.detector import check_transfer_format
from ..device import config_device, resolve_device
from ..services.checkpoint_service import CheckpointService
from ..services.output_service import OutputService
from ..services.perf_service import PerformanceService
from ..video.video_processor import VideoProcessor
from .frame_extraction_pipeline import ExtractedFrame, FrameExtractionPipeline
from .phases.aggregation import AggregationPhase
from .phases.detection import DetectionPhase
from .phases.tracking import TrackingPhase
from .phases.transform import TransformPhase
from .phases.visualization import SIDE_BY_SIDE_REFUSAL, VisualizationPhase

#: Config keys whose ``true`` asks for a part the port does not have yet,
#: with the ROADMAP item that brings it.
UNPORTED_KEYS = {
    "output.save_side_by_side_video": SIDE_BY_SIDE_REFUSAL,
    "output.save_attention_maps": "the attention-map overlays are not ported yet (ROADMAP A.3)",
}


def refuse_unported(config: Any) -> None:
    """Raise ``NotImplementedError`` for the first key of
    :data:`UNPORTED_KEYS` that the config turns on, and ``ValueError`` for a
    ``detection.transfer_format`` that is none of bgr, i420, i420d and
    auto, before Phase 1 runs."""
    for key, why in UNPORTED_KEYS.items():
        if config.get(key, False):
            raise NotImplementedError(f"{key}: {why}")
    check_transfer_format(config.get("detection.transfer_format", "bgr"))


class PipelineOrchestrator:
    def __init__(
        self,
        config: Any,
        logger: logging.Logger | None = None,
        detector: Any = None,
    ):
        refuse_unported(config)
        # The device first: a run that asks for a card where there is none
        # fails here, not after Phase 1's OCR.
        resolve_device(config_device(config), str(config.get("detection.dtype", "bfloat16")))
        self.config = config
        self.logger = logger or logging.getLogger(__name__)
        self.detector_override = detector  # a detector with its weights loaded
        self.output = OutputService(config.get("output.directory", "output"))
        self.checkpoints: CheckpointService | None = None
        self.perf = PerformanceService(
            trace_dir=config.get("performance.trace_dir", None)
        )
        self.frame_results: list[FrameResult] = []
        self.frames: list[np.ndarray] = []
        self.aggregation_results: list[AggregationResult] = []
        self.detection_phase: DetectionPhase | None = None
        self.statistics: dict[str, Any] = {}

    # ------------------------------------------------------------- session
    def setup_output_directories(self, resume_session: str | Path | None = None) -> Path:
        """(reference orchestrator.py:50-62)"""
        if resume_session:
            session_dir = self.output.attach(resume_session)
            self.logger.info("resuming session %s", session_dir)
        else:
            session_dir = self.output.setup(self.config.as_dict())
        self.checkpoints = CheckpointService(session_dir)
        return session_dir

    def _phase_dir(self, phase: str) -> Path:
        return self.output.get_phase_dir(phase)

    # -------------------------------------------------------------- phase 1
    def extract_frames(
        self,
        start_time: datetime | None = None,
        end_time: datetime | None = None,
    ) -> list[ExtractedFrame]:
        """(reference orchestrator.py:80-151)"""
        out_dir = self._phase_dir("01_extraction")
        with self.perf.measure("01_extraction"):
            pipeline = FrameExtractionPipeline(self.config, out_dir)
            mode = str(self.config.get("timestamp.extraction_mode", "auto_targets"))
            if mode == "manual_targets":
                targets = self._build_manual_targets(start_time, end_time)
                extracted = pipeline.run(targets)
            else:
                extracted = pipeline.run_with_auto_targets()
                if start_time or end_time:
                    extracted = [
                        e for e in extracted
                        if (start_time is None or e.timestamp >= start_time)
                        and (end_time is None or e.timestamp <= end_time)
                    ]
            stats = pipeline.extractor.get_cache_stats()
            self.logger.info(
                "extracted %d frames (OCR cache hit rate %.1f%%)",
                len(extracted), 100 * stats.get("hit_rate", 0.0),
            )
        self.frame_results = [
            FrameResult(
                frame_number=e.frame_number,
                timestamp=e.timestamp,
                frame_path=e.frame_path,
            )
            for e in extracted
        ]
        self.checkpoints.save(
            "01_extraction", data={"frames_extracted": len(extracted)}
        )
        return extracted

    def _build_manual_targets(
        self, start_time: datetime | None, end_time: datetime | None
    ) -> list[datetime]:
        from datetime import timedelta

        targets_cfg = self.config.get("timestamp.manual_targets", []) or []
        if targets_cfg:
            return [
                datetime.fromisoformat(t) if isinstance(t, str) else t
                for t in targets_cfg
            ]
        if start_time and end_time:
            step = timedelta(
                minutes=float(self.config.get("video.frame_interval_minutes", 5))
            )
            targets, t = [], start_time
            while t <= end_time:
                targets.append(t)
                t += step
            return targets
        raise ValueError(
            "manual_targets mode needs timestamp.manual_targets or --start/--end-time"
        )

    # ----------------------------------------------------- frame re-loading
    def prepare_frames_for_detection(self) -> list[np.ndarray]:
        """Load decoded frames for the selected FrameResults.

        Fallback chain (reference orchestrator.py:173-192): in-memory ->
        frame_path on disk -> re-decode from the source video.
        """
        import cv2

        frames: list[np.ndarray] = []
        keep: list[FrameResult] = []
        video: VideoProcessor | None = None
        video_open_failed = False
        try:
            for fr in self.frame_results:
                frame = None
                if fr.frame_path and Path(fr.frame_path).exists():
                    frame = cv2.imread(fr.frame_path)
                if frame is None:
                    if video is None and not video_open_failed:
                        # The source video may itself be gone or unreadable
                        # (resumed session moved to another machine); the
                        # chain must degrade to dropping the frame, not crash
                        # (reference :173-192). Probe once, not per frame.
                        try:
                            video = VideoProcessor(
                                self.config.get("video.input_path", "")
                            )
                            if not video.open():
                                video = None
                        except (OSError, ValueError) as e:
                            self.logger.warning("source video unavailable: %s", e)
                            video = None
                        if video is None:
                            video_open_failed = True
                    if video is not None:
                        frame = video.get_frame(fr.frame_number)
                if frame is None:
                    self.logger.warning(
                        "frame %d unavailable; dropping", fr.frame_number
                    )
                    continue
                frames.append(frame)
                keep.append(fr)
        finally:
            if video is not None:
                video.release()
        self.frame_results = keep
        self.frames = frames
        return frames

    # -------------------------------------------------------------- phase 2
    def run_detection(self) -> list[FrameResult]:
        """(reference orchestrator.py:204-231)"""
        out_dir = self._phase_dir("02_detection")
        self.detection_phase = DetectionPhase(
            self.config, self.logger, detector=self.detector_override
        )
        with self.perf.measure("02_detection"):
            self.detection_phase.execute(self.frames, self.frame_results, out_dir)
        self.checkpoints.save(
            "02_detection", data=self.detection_phase.statistics
        )
        return self.frame_results

    # ------------------------------------------------------------ phase 2.5
    def run_tracking(self) -> list[FrameResult]:
        """(reference orchestrator.py:234-281; skipped when disabled)"""
        if not self.config.get("tracking.enabled", False):
            self.logger.info("tracking disabled; skipping phase 2.5")
            self.checkpoints.save("03_tracking", status="skipped")
            return self.frame_results
        out_dir = self._phase_dir("03_tracking")
        phase = TrackingPhase(self.config, self.logger)
        detection_batch = None
        if self.detection_phase is not None:
            phase.set_detector(self.detection_phase.detector)
            detection_batch = self.detection_phase.last_batch
        with self.perf.measure("03_tracking"):
            phase.execute(self.frame_results, self.frames or None, out_dir, detection_batch=detection_batch)
            if self.config.get("video.dense_tracking.enabled", False):
                self.frame_results = phase.aggregate_to_output_intervals(self.frame_results)
        self.checkpoints.save("03_tracking", data=phase.statistics)
        phase.cleanup()
        return self.frame_results

    # -------------------------------------------------------------- phase 3
    def run_transform(self) -> list[FrameResult]:
        """(reference orchestrator.py:285-309)"""
        out_dir = self._phase_dir("04_transform")
        phase = TransformPhase(self.config, self.logger)
        with self.perf.measure("04_transform"):
            phase.execute(self.frame_results, out_dir)
        self.checkpoints.save("04_transform", data=phase.statistics)
        self._transform_phase = phase
        return self.frame_results

    # -------------------------------------------------------------- phase 4
    def run_aggregation(self) -> list[AggregationResult]:
        """(reference orchestrator.py:313-332)"""
        out_dir = self._phase_dir("05_aggregation")
        phase = AggregationPhase(self.config, self.logger)
        with self.perf.measure("05_aggregation"):
            self.aggregation_results = phase.execute(self.frame_results, out_dir)
        self._aggregation_phase = phase
        self.checkpoints.save(
            "05_aggregation", data={"timestamps": len(self.aggregation_results)}
        )
        return self.aggregation_results

    # -------------------------------------------------------------- phase 5
    def run_visualization(self) -> dict[str, Any]:
        """(reference orchestrator.py:336-353)"""
        out_dir = self._phase_dir("06_visualization")
        phase = VisualizationPhase(self.config, self.logger)
        zone_stats = None
        agg = getattr(self, "_aggregation_phase", None)
        if agg is not None:
            zone_stats = agg.aggregator.get_statistics()
        with self.perf.measure("06_visualization"):
            generated = phase.execute(
                self.frame_results,
                self.aggregation_results,
                out_dir,
                zone_statistics=zone_stats,
                detection_image_dir=self._phase_dir("02_detection"),
            )
        self.checkpoints.save(
            "06_visualization",
            data={"floormaps_generated": int(generated.get("floormaps", 0))},
        )
        return generated

    # ------------------------------------------------------------- summary
    def save_session_summary(self, status: str = "completed") -> Path:
        """summary.json (reference orchestrator.py:355-391, schema
        schemas/summary.schema.json)."""
        total_dets = sum(len(fr.detections) for fr in self.frame_results)
        nframes = len(self.frame_results)
        self.statistics = {
            "frames_extracted": nframes,
            "frames_processed": nframes,
            "total_detections": total_dets,
            "avg_detections_per_frame": (total_dets / nframes) if nframes else 0.0,
            "zones_count": len(self.config.get("zones", [])),
        }
        summary = {
            "session_id": self.output.session_id,
            "timestamp": datetime.now().isoformat(),
            "status": status,
            "statistics": self.statistics,
            "performance": self.perf.summary(),
        }
        return self.output.save_summary(summary)

    # --------------------------------------------------------------- resume
    def reload_phase_artifacts(self) -> None:
        """Rebuild in-memory state from a resumed session's artifacts."""
        extraction_csv = self._phase_dir("01_extraction") / "extraction_results.csv"
        if extraction_csv.exists():
            import csv as _csv

            self.frame_results = []
            with extraction_csv.open() as f:
                for row in _csv.DictReader(f):
                    self.frame_results.append(
                        FrameResult(
                            frame_number=int(row["frame_number"]),
                            timestamp=datetime.strptime(
                                row["timestamp"], "%Y-%m-%d %H:%M:%S"
                            ),
                            frame_path=row.get("frame_path") or None,
                        )
                    )
        # Prefer the Phase-3 artifact (has floor coords + zones); fall back
        # to Phase 2's raw detections when transform hasn't run yet.
        transform_json = self._phase_dir("04_transform") / "coordinate_transformations.json"
        detections_json = self._phase_dir("02_detection") / "detections.json"
        doc = None
        if transform_json.exists() and self.checkpoints.is_completed("04_transform"):
            doc = json.loads(transform_json.read_text())
        elif detections_json.exists() and self.checkpoints.is_completed("02_detection"):
            doc = json.loads(detections_json.read_text())
        if doc is not None:
            by_number = {fr.frame_number: fr for fr in self.frame_results}
            for fdoc in doc.get("frames", []):
                num = fdoc.get("frame_number", fdoc.get("idx"))
                fr = by_number.get(num)
                if fr is None:
                    continue
                fr.detections = [
                    _detection_from_dict(d) for d in fdoc.get("detections", fdoc.get("det", []))
                ]

    # ----------------------------------------------------------------- run
    def run(
        self,
        start_time: datetime | None = None,
        end_time: datetime | None = None,
        resume_session: str | Path | None = None,
        timestamps_only: bool = False,
    ) -> dict[str, Any]:
        """Full 5-phase run (reference main.py:20-136 flow), with resume,
        inside the ``performance.trace_dir`` trace when one is set."""
        with self.perf:
            return self._run(start_time, end_time, resume_session, timestamps_only)

    def _run(
        self,
        start_time: datetime | None,
        end_time: datetime | None,
        resume_session: str | Path | None,
        timestamps_only: bool,
    ) -> dict[str, Any]:
        self.setup_output_directories(resume_session)
        done = self.checkpoints.is_completed if resume_session else (lambda _p: False)

        if done("01_extraction"):
            self.logger.info("phase 1 already complete; reloading artifacts")
            self.reload_phase_artifacts()
            if start_time or end_time:
                # The resumed artifact holds the full extraction; apply the
                # requested analysis window just like a fresh run would.
                self.frame_results = [
                    fr for fr in self.frame_results
                    if (start_time is None or fr.timestamp >= start_time)
                    and (end_time is None or fr.timestamp <= end_time)
                ]
        else:
            self.extract_frames(start_time, end_time)
        if timestamps_only:
            self.save_session_summary()
            return {"frames": len(self.frame_results)}

        needs_frames = not (done("02_detection") and done("04_transform"))
        if needs_frames or self.config.get("tracking.enabled", False):
            self.prepare_frames_for_detection()

        if not done("02_detection"):
            self.run_detection()
        if not done("03_tracking"):
            self.run_tracking()
        if not done("04_transform"):
            self.run_transform()
        if not done("05_aggregation") or not self.aggregation_results:
            self.run_aggregation()
        if not done("06_visualization"):
            self.run_visualization()

        self.save_session_summary()
        self.perf.log_summary()
        return {
            "session_dir": str(self.output.session_dir),
            "statistics": self.statistics,
        }

    # --------------------------------------------------------------- misc
    def parse_datetime_range(
        self, start: str | None, end: str | None
    ) -> tuple[datetime | None, datetime | None]:
        """(reference orchestrator.py:393-427)"""

        def _parse(s: str | None) -> datetime | None:
            if not s:
                return None
            for fmt in ("%Y-%m-%d %H:%M:%S", "%Y-%m-%d %H:%M", "%Y-%m-%dT%H:%M:%S"):
                try:
                    return datetime.strptime(s, fmt)
                except ValueError:
                    continue
            raise ValueError(f"unparseable datetime: {s!r}")

        return _parse(start), _parse(end)

    def cleanup(self) -> None:
        """(reference orchestrator.py:431-454)"""
        from ..utils.memory_utils import cleanup_resources

        if self.detection_phase is not None:
            cleanup_resources(self.detection_phase)
        self.frames = []


def _detection_from_dict(d: dict[str, Any]) -> Detection:
    """Inverse of Detection.to_dict / to_compact_dict (resume path)."""
    if "bb" in d:  # compact form
        det = Detection(bbox=tuple(d["bb"]), confidence=float(d["conf"]))
        if "floor_mm" in d:
            det.floor_coords_mm = tuple(d["floor_mm"])
        if "floor_px" in d:
            det.floor_coords_px = tuple(d["floor_px"])
        det.zone_ids = list(d.get("zones", []))
        if "id" in d:
            det.track_id = int(d["id"])
        return det
    bbox = d["bbox"]
    det = Detection(
        bbox=(bbox["x"], bbox["y"], bbox["width"], bbox["height"]),
        confidence=float(d["confidence"]),
    )
    if "floor_coords_px" in d:
        det.floor_coords_px = (d["floor_coords_px"]["x"], d["floor_coords_px"]["y"])
    if "floor_coords_mm" in d:
        det.floor_coords_mm = (d["floor_coords_mm"]["x"], d["floor_coords_mm"]["y"])
    det.zone_ids = list(d.get("zone_ids", []))
    if "track_id" in d:
        det.track_id = int(d["track_id"])
    return det
