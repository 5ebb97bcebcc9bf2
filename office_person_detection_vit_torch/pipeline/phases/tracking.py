"""Phase 2.5: multi-object tracking.

Mirrors ``office_person_detection_vit_tpu/pipeline/phases/tracking.py``:
``tracking.engine`` picks the cascade (the default, host numpy/scipy) or the
scan tracker (the whole sequence on ``detection.device``, the card unless
``"cpu"``); ``tracking.hybrid_mode.enabled`` runs the hybrid tracker with
optical flow instead of either. Detections gain ``track_id``. The appearance
features are Phase 2's encoder features pooled under each box (the detector
shared through ``set_detector``), or a Re-ID extractor's
(``tracking.reid.enabled``). The phase writes ``tracks.csv``,
``tracks_mot.csv``, ``tracks.json``, ``frames_index.csv`` and
``tracking_statistics.json`` and, with ``output.save_tracking_images``,
tracked frames; ``aggregate_to_output_intervals`` turns a dense-tracking
run into output windows with one detection per track id.
"""

from __future__ import annotations

import json
from collections import defaultdict
from datetime import datetime
from pathlib import Path
from typing import Any

import numpy as np

from ...core.dto import Detection, FrameResult
from ...device import config_device
from ...tracking.reid_feature_extractor import ReIDFeatureExtractor
from ...tracking.tracker import Tracker
from ...utils.export_utils import TrajectoryExporter
from ...utils.image_utils import save_tracked_detection_image
from .base import BasePhase


def _as_datetime(ts):
    """A FrameResult timestamp as a datetime, or None (an ISO string is
    parsed; one that does not parse is None)."""
    if isinstance(ts, str):
        try:
            return datetime.fromisoformat(ts)
        except ValueError:
            return None
    return ts


class TrackingPhase(BasePhase):
    name = "03_tracking"

    def __init__(self, config: Any, logger=None):
        super().__init__(config, logger)
        self.tracker: Tracker | None = None
        self.light_tracker = None
        self.reid: ReIDFeatureExtractor | None = None
        self.detector = None
        self.hybrid = bool(config.get("tracking.hybrid_mode.enabled", False))
        self.engine = str(config.get("tracking.engine", "cascade"))
        self.save_images = bool(config.get("output.save_tracking_images", False))
        self.statistics: dict[str, Any] = {}

    def set_detector(self, detector) -> None:
        """Share Phase 2's detector (its encoder features)."""
        self.detector = detector

    def initialize(self) -> None:
        if self.hybrid and self.light_tracker is None:
            from ...tracking.lightweight_tracker import LightweightTracker

            self.light_tracker = LightweightTracker(
                iou_threshold=float(self.config.get("tracking.iou_threshold", 0.3)),
                max_age=int(self.config.get("tracking.max_age", 30)),
                use_optical_flow=bool(self.config.get("tracking.hybrid_mode.use_optical_flow", True)),
            )
        if self.tracker is None:
            self.tracker = Tracker.from_config(self.config)
        if self.config.get("tracking.reid.enabled", False) and self.reid is None:
            self.reid = ReIDFeatureExtractor.from_config(self.config)
            self.reid.detector = self.detector
            self.reid.load_model()

    def _attach_detector_features(self, frame_results, detection_batch, frames=None) -> None:
        """Give each detection its encoder features pooled under its box, so
        that the appearance stages run without a Re-ID model. Without Phase
        2's batch in this process (a resumed session), the detector's crop
        histograms where frames are given, else nothing."""
        if (
            detection_batch is None
            or self.detector is None
            or not hasattr(self.detector, "_pool_features")
            or getattr(self.detector, "_last_encoder_chunks", None) in (None, [])
        ):
            if frames is not None and self.detector is not None and hasattr(self.detector, "extract_features"):
                for fr, frame in zip(frame_results, frames):
                    dets = [d for d in fr.detections if d.feature is None]
                    if not dets or frame is None:
                        continue
                    try:
                        feats = self.detector.extract_features(frame, [d.bbox for d in dets])
                    except Exception as e:  # features improve matching; a frame without them still tracks
                        self.logger.warning("could not extract crop features for frame %s: %s", fr.frame_number, e)
                        continue
                    for det, f in zip(dets, feats):
                        det.feature = np.asarray(f, np.float32)
            return
        try:
            feats = self.detector._pool_features(detection_batch).cpu().numpy()
            valid = np.asarray(detection_batch.valid)
        except Exception as e:  # features improve matching; tracking runs without them
            self.logger.warning("could not pool detector features: %s", e)
            return
        for fi, fr in enumerate(frame_results):
            if fi >= len(feats):
                break
            for det, f in zip(fr.detections, feats[fi][valid[fi]]):
                if det.feature is None:
                    det.feature = np.asarray(f, np.float32)

    def _reid_features(self, dets: list[Detection], frame) -> None:
        if self.reid is not None and frame is not None and dets:
            for d, f in zip(dets, self.reid.extract_features(frame, [d.bbox for d in dets])):
                d.feature = f

    def execute(self, frame_results: list[FrameResult], frames: list[np.ndarray] | None = None,
                output_dir: str | Path | None = None, detection_batch=None) -> list[FrameResult]:
        """Track identities across the sampled frames (in timestamp order);
        detections gain ``track_id`` in place. ``detection_batch`` is Phase
        2's ``DetectionBatch``, whose encoder features are pooled for the
        appearance cost when no Re-ID extractor is configured."""
        self.log_banner()
        self.initialize()
        if self.reid is None:
            self._attach_detector_features(frame_results, detection_batch, frames)
        if self.engine == "scan" and self.hybrid:
            self.logger.warning(
                "tracking.engine=scan is ignored because tracking.hybrid_mode.enabled is set; running the hybrid "
                "lightweight tracker")
        if self.engine == "scan" and not self.hybrid:
            id_set = self._run_scan(frame_results, frames)
        else:
            id_set = self._run_online(frame_results, frames)
        if self.save_images and frames is not None and output_dir is not None:
            for fr, frame in zip(frame_results, frames):
                if frame is not None:
                    save_tracked_detection_image(frame, fr.detections,
                                                 Path(output_dir) / f"tracked_{fr.timestamp_stem}.jpg")
        self.statistics = self._compute_statistics(frame_results, id_set)
        if output_dir is not None:
            self.export_results(frame_results, Path(output_dir))
        self.logger.info("tracked %d frames (%s): %d unique ids", len(frame_results),
                         "hybrid" if self.hybrid else self.engine, len(id_set))
        return frame_results

    def _run_scan(self, frame_results: list[FrameResult], frames) -> set[int]:
        """The whole sequence in one scan on ``detection.device``, with the
        cascade's defaults, so that switching engines keeps retention and
        confirmation."""
        from ...tracking.scan_tracker import assign_track_ids

        if frames is not None:  # the scan needs the Re-ID features up front
            for fr, frame in zip(frame_results, frames):
                self._reid_features(fr.detections, frame)
        ids = assign_track_ids(
            frame_results,
            device=config_device(self.config),
            max_age=int(self.config.get("tracking.max_age", 100)),
            min_hits=int(self.config.get("tracking.min_hits", 1)),
            appearance_weight=float(self.config.get("tracking.appearance_weight", 0.9)),
            motion_weight=float(self.config.get("tracking.motion_weight", 0.1)),
            max_position_distance=float(self.config.get("tracking.max_position_distance", 10000.0)),
        )
        return {int(i) for i in np.unique(ids) if i >= 0}

    def _run_online(self, frame_results: list[FrameResult], frames) -> set[int]:
        """The cascade, or the hybrid tracker, frame by frame. Wall-clock
        seconds drive the adaptive-dt Kalman (the frame index where a frame
        has no timestamp)."""
        id_set: set[int] = set()
        for i, fr in enumerate(frame_results):
            frame = frames[i] if frames is not None else None
            dets = fr.detections
            self._reid_features(dets, frame)
            ts = _as_datetime(fr.timestamp)
            timestamp = ts.timestamp() if isinstance(ts, datetime) else float(i)
            if not self.hybrid:
                self.tracker.update(dets, timestamp)
            elif dets:  # a detection frame: greedy association, ids in place
                self.light_tracker.update_with_detections(dets, frame, timestamp)
            else:  # no detections: optical flow or the Kalman prediction
                for t in self.light_tracker.interpolate(frame, timestamp):
                    dets.append(Detection(bbox=tuple(t.bbox), confidence=t.confidence, track_id=t.track_id))
            id_set.update(d.track_id for d in dets if d.track_id is not None)
        return id_set

    def _compute_statistics(self, frame_results: list[FrameResult], id_set: set[int]) -> dict[str, Any]:
        lengths = defaultdict(int)
        for fr in frame_results:
            for d in fr.detections:
                if d.track_id is not None:
                    lengths[d.track_id] += 1
        return {
            "total_frames": len(frame_results),
            "unique_tracks": len(id_set),
            "avg_track_length": float(np.mean(list(lengths.values()))) if lengths else 0.0,
            "max_track_length": int(max(lengths.values())) if lengths else 0,
        }

    def export_results(self, frame_results: list[FrameResult], output_dir: Path) -> dict[str, Path]:
        """tracks.csv, tracks_mot.csv, tracks.json, frames_index.csv and
        tracking_statistics.json."""
        output_dir.mkdir(parents=True, exist_ok=True)
        exporter = TrajectoryExporter(output_dir)
        paths = {
            "csv": exporter.export_csv(frame_results),
            "mot": exporter.export_mot_csv(frame_results),
            "json": exporter.export_json(frame_results),
            "frame_index": exporter.export_frame_index(frame_results),
        }
        stats_path = output_dir / "tracking_statistics.json"
        stats_path.write_text(json.dumps(self.statistics, indent=2), encoding="utf-8")
        paths["statistics"] = stats_path
        return paths

    def aggregate_to_output_intervals(self, frame_results: list[FrameResult],
                                      output_interval_minutes: float | None = None) -> list[FrameResult]:
        """Dense tracking (such as every 10 s) -> output windows (such as 5
        min), each keeping one detection per track id (its most confident),
        so that a person seen in 30 dense frames counts once a window. Every
        window with a frame is kept, one with no tracked detection as an
        empty frame."""
        if output_interval_minutes is None:
            output_interval_minutes = float(self.config.get("video.dense_tracking.output_interval_minutes", 5))
        window_s = output_interval_minutes * 60.0
        windows: dict[int, dict[int, Any]] = defaultdict(dict)  # window -> id -> detection
        window_meta: dict[int, FrameResult] = {}
        for fr in frame_results:
            ts = fr.timestamp
            if isinstance(ts, str):
                ts = datetime.fromisoformat(ts)
            if ts is None:
                continue
            win = int(ts.timestamp() // window_s)
            window_meta.setdefault(win, fr)
            for d in fr.detections:
                if d.track_id is None:
                    continue
                cur = windows[win].get(d.track_id)
                if cur is None or d.confidence > cur.confidence:
                    windows[win][d.track_id] = d
        return [
            FrameResult(frame_number=window_meta[win].frame_number, timestamp=window_meta[win].timestamp,
                        detections=list(windows[win].values()) if win in windows else [],
                        frame_path=window_meta[win].frame_path)
            for win in sorted(window_meta)
        ]

    def cleanup(self) -> None:
        if self.reid is not None:
            self.reid.cleanup()
        self.reid = None
