"""Phase 1 — timestamp-targeted frame extraction
(reference src/pipeline/frame_extraction_pipeline.py:26-582).

Two modes (config ``timestamp.extraction_mode``):

* ``auto_targets`` (:meth:`run_with_auto_targets`, reference :328-563) —
  scan the whole video at a coarse stride, OCR every scanned frame through a
  host thread pool fed by the prefetch loader, generate a 5-minute target
  grid between the first and last readable timestamps, and pick the nearest
  scanned frame within tolerance for each target.
* ``manual_targets`` (:meth:`run`, reference :151-271) — per explicit target
  timestamp do a coarse scan with early exit once OCR time passes the
  target, then a fine search around the approximate hit.

The OCR subsystem stays on host (SURVEY.md §2.5); the card never sees Phase 1.
Time-compression mapping: actual wall seconds / ratio = video seconds
(reference :574-582).

The port's own copy of ``office_person_detection_vit_tpu/pipeline/frame_extraction_pipeline.py`` (host code; only this docstring differs).
"""

from __future__ import annotations

import csv
import logging
from dataclasses import dataclass
from datetime import datetime, timedelta
from pathlib import Path
from typing import Any

import cv2
import numpy as np

from ..timestamp.timestamp_extractor import TimestampExtractorV2
from ..video.frame_sampler import CoarseSampler, FineSampler
from ..video.prefetch import PrefetchLoader
from ..video.video_processor import VideoProcessor

logger = logging.getLogger(__name__)


@dataclass
class ExtractedFrame:
    frame_number: int
    timestamp: datetime
    target_timestamp: datetime | None
    confidence: float
    frame_path: str | None = None
    time_error_seconds: float = 0.0


class FrameExtractionPipeline:
    def __init__(self, config: Any, output_dir: str | Path = "output/01_extraction"):
        self.config = config
        self.output_dir = Path(output_dir)
        self.video_path = str(config.get("video.input_path", ""))
        self.fps = float(config.get("video.fps", 30.0))
        self.interval_minutes = float(config.get("video.frame_interval_minutes", 5))
        self.tolerance_seconds = float(config.get("video.tolerance_seconds", 60))
        self.compression_ratio = float(config.get("video.time_compression_ratio", 313.0))
        self.coarse_interval = float(
            config.get("timestamp.sampling.coarse_interval_seconds", 5.0)
        )
        # Dense tracking samples the grid at tracking_interval_seconds
        # (e.g. 10 s) instead of the 5-minute output grid; Phase 2.5 then
        # re-aggregates to output windows (reference phases/tracking.py:388-483).
        if config.get("video.dense_tracking.enabled", False):
            dense_s = float(
                config.get("video.dense_tracking.tracking_interval_seconds", 10)
            )
            self.interval_minutes = dense_s / 60.0
            self.tolerance_seconds = min(self.tolerance_seconds, dense_s / 2)
            # The coarse scan must sample at least twice per dense-grid step
            # (in wall-clock terms) or most targets have no frame in
            # tolerance; convert the dense wall interval to video seconds.
            max_scan_video_s = dense_s / self.compression_ratio / 2
            self.coarse_interval = min(self.coarse_interval, max(
                max_scan_video_s, 1.0 / self.fps
            ))
        self.fine_interval = float(
            config.get("timestamp.sampling.fine_interval_seconds", 1.0)
        )
        self.search_window = float(
            config.get("timestamp.sampling.search_window_seconds", 30.0)
        )
        self.max_scan_frames = int(config.get("timestamp.auto_targets.max_frames", 290))
        self.save_frames = bool(config.get("output.save_extracted_frames", True))
        self.extractor = TimestampExtractorV2.from_config(config)
        self.video = VideoProcessor(self.video_path)

    # ------------------------------------------------------------- helpers
    def _to_video_seconds(self, actual_seconds: float) -> float:
        """Wall-clock seconds -> video seconds under timelapse compression,
        floored to at least one frame (reference :574-582)."""
        return max(actual_seconds / self.compression_ratio, 1.0 / self.fps)

    def _save_frame(self, frame: np.ndarray, ts: datetime) -> str:
        frames_dir = self.output_dir / "frames"
        frames_dir.mkdir(parents=True, exist_ok=True)
        path = frames_dir / f"frame_{ts.strftime('%Y%m%d_%H%M%S')}.jpg"
        cv2.imwrite(str(path), frame, [cv2.IMWRITE_JPEG_QUALITY, 95])
        return str(path)

    def _write_csv(self, rows: list[ExtractedFrame]) -> Path:
        self.output_dir.mkdir(parents=True, exist_ok=True)
        path = self.output_dir / "extraction_results.csv"
        with path.open("w", newline="", encoding="utf-8") as f:
            writer = csv.writer(f)
            writer.writerow(
                [
                    "frame_number",
                    "timestamp",
                    "target_timestamp",
                    "confidence",
                    "time_error_seconds",
                    "frame_path",
                ]
            )
            for r in rows:
                writer.writerow(
                    [
                        r.frame_number,
                        r.timestamp.strftime("%Y-%m-%d %H:%M:%S"),
                        r.target_timestamp.strftime("%Y-%m-%d %H:%M:%S")
                        if r.target_timestamp
                        else "",
                        f"{r.confidence:.3f}",
                        f"{r.time_error_seconds:.1f}",
                        r.frame_path or "",
                    ]
                )
        return path

    # --------------------------------------------------------- auto targets
    def run_with_auto_targets(self) -> list[ExtractedFrame]:
        """Full-scan mode: OCR the coarse grid once, derive targets, select
        nearest frames (reference :328-563)."""
        if not self.video.open():
            logger.error("could not open video %s", self.video_path)
            return []
        try:
            # Auto-targets selects scanned frames directly (no fine pass),
            # so the scan grid must be dense enough in WALL-CLOCK terms:
            # under timelapse compression a video-seconds stride of 5 s is
            # 5*ratio wall seconds (~26 min at the production ratio 313) —
            # no scanned frame would land within tolerance of any 5-minute
            # target. Cap the stride so scanned frames are at most
            # tolerance_seconds apart in wall clock (worst-case target
            # error = tolerance/2)...
            scan_interval = min(
                self.coarse_interval,
                self._to_video_seconds(self.tolerance_seconds),
            )
            # ...but never truncate COVERAGE: if the densified grid exceeds
            # the max_scan_frames budget, widen the stride to span the
            # whole video within it (coverage beats density — a sparser
            # grid degrades time error gracefully, truncation silently
            # drops every target past the cutoff).
            budget_interval = self.video.frame_count / max(
                self.max_scan_frames, 1) / self.fps
            if budget_interval > scan_interval:
                logger.warning(
                    "auto-targets scan capped at %d frames: stride widened "
                    "to %.2fs video (%.0fs wall) > tolerance-ideal %.2fs; "
                    "raise timestamp.auto_targets.max_frames for tighter "
                    "time errors",
                    self.max_scan_frames, budget_interval,
                    budget_interval * self.compression_ratio, scan_interval,
                )
                scan_interval = budget_interval
            sampler = CoarseSampler(scan_interval, self.fps)
            scan_frames = list(
                sampler.sample(self.video.frame_count)
            )[: self.max_scan_frames]
            logger.info(
                "auto-targets scan: %d frames at stride %d (video has %d; "
                "wall gap %.0fs)",
                len(scan_frames), sampler.stride, self.video.frame_count,
                sampler.stride / self.fps * self.compression_ratio,
            )

            # Prefetch decode on a host thread (sequential strided read —
            # ~10x faster than per-frame seeks); OCR pool consumes batches.
            timestamps: dict[int, tuple[datetime, float]] = {}
            loader = PrefetchLoader(
                scan_frames, iter_fn=self.video.iter_frames,
                batch_size=16, depth=3,
            )
            for numbers, frames in loader:
                results = self.extractor.extract_batch_parallel(
                    [(fn, frames[i]) for i, fn in enumerate(numbers)]
                )
                for fn, ts, conf in results:
                    if ts is not None:
                        timestamps[fn] = (ts, conf)
            stats = self.extractor.get_cache_stats()
            logger.info(
                "scan OCR'd %d/%d frames (cache hit rate %.1f%%)",
                len(timestamps), len(scan_frames), 100 * stats.get("hit_rate", 0.0),
            )
            if not timestamps:
                return []

            targets = self._generate_targets(timestamps)
            rows = self._select_nearest(timestamps, targets)
            results = self._materialize(rows)
            self._write_csv(results)
            return results
        finally:
            self.video.release()

    def _generate_targets(
        self, timestamps: dict[int, tuple[datetime, float]]
    ) -> list[datetime]:
        """5-minute grid from first readable timestamp (rounded up) to last
        (reference :431-456)."""
        times = [ts for ts, _ in timestamps.values()]
        start, end = min(times), max(times)
        step = timedelta(minutes=self.interval_minutes)
        # Round start up to the next grid boundary.
        minutes = (
            int(np.ceil((start.minute + start.second / 60) / self.interval_minutes))
            * self.interval_minutes
        )
        first = start.replace(minute=0, second=0, microsecond=0) + timedelta(
            minutes=minutes
        )
        targets = []
        t = first
        while t <= end:
            targets.append(t)
            t += step
        logger.info("generated %d targets between %s and %s", len(targets), start, end)
        return targets

    def _select_nearest(
        self,
        timestamps: dict[int, tuple[datetime, float]],
        targets: list[datetime],
    ) -> list[ExtractedFrame]:
        """Nearest scanned frame per target within tolerance (reference
        :462-501). Each frame is used at most once."""
        rows: list[ExtractedFrame] = []
        used: set[int] = set()
        for target in targets:
            best_fn, best_err = None, float("inf")
            for fn, (ts, _conf) in timestamps.items():
                if fn in used:
                    continue
                err = abs((ts - target).total_seconds())
                if err < best_err:
                    best_fn, best_err = fn, err
            if best_fn is not None and best_err <= self.tolerance_seconds:
                used.add(best_fn)
                ts, conf = timestamps[best_fn]
                rows.append(
                    ExtractedFrame(
                        frame_number=best_fn,
                        timestamp=ts,
                        target_timestamp=target,
                        confidence=conf,
                        time_error_seconds=best_err,
                    )
                )
            else:
                logger.warning(
                    "no frame within %.0fs of target %s (best %.0fs)",
                    self.tolerance_seconds, target, best_err,
                )
        return rows

    def _materialize(self, rows: list[ExtractedFrame]) -> list[ExtractedFrame]:
        """Re-decode and save the selected frames."""
        for row in rows:
            frame = self.video.get_frame(row.frame_number)
            if frame is None:
                continue
            if self.save_frames:
                row.frame_path = self._save_frame(frame, row.timestamp)
        return rows

    # ------------------------------------------------------- manual targets
    def run(self, target_timestamps: list[datetime]) -> list[ExtractedFrame]:
        """Per-target coarse scan + fine search (reference :151-271)."""
        if not self.video.open():
            logger.error("could not open video %s", self.video_path)
            return []
        try:
            results: list[ExtractedFrame] = []
            for target in target_timestamps:
                approx = self._find_approximate_frame(target)
                if approx is None:
                    logger.warning("target %s: no approximate frame found", target)
                    continue
                best = self._find_best_frame_around(target, approx)
                if best is None:
                    logger.warning("target %s: no frame within tolerance", target)
                    continue
                results.append(best)
            results = self._materialize(results)
            self._write_csv(results)
            return results
        finally:
            self.video.release()

    def _find_approximate_frame(self, target: datetime) -> int | None:
        """Coarse scan; early exit once OCR time passes target + 1 minute
        (reference :199-228)."""
        last_valid: int | None = None
        for fn in CoarseSampler(self.coarse_interval, self.fps).sample(
            self.video.frame_count
        ):
            frame = self.video.get_frame(fn)
            if frame is None:
                continue
            ts, _conf = self.extractor.extract(frame, fn)
            if ts is None:
                continue
            if ts >= target + timedelta(minutes=1):
                return last_valid if last_valid is not None else fn
            last_valid = fn
            if abs((ts - target).total_seconds()) <= self.coarse_interval * 2:
                return fn
        return last_valid

    def _find_best_frame_around(
        self, target: datetime, approx_frame: int
    ) -> ExtractedFrame | None:
        """Fine scan ±search_window around the approximate frame; keep
        candidates within tolerance and pick min |Δt| (reference :230-271)."""
        # Wall-aware under timelapse compression: the fine step is capped
        # so consecutive samples are at most tolerance/2 apart in WALL
        # clock (a 1 s video step is ~5 wall-minutes at ratio 313 — it
        # would jump straight over the 60 s tolerance window), and the
        # scan centers on the frame PREDICTED from the approximate frame's
        # own timestamp via the time-compression map, so the window stays
        # small. When centering fails (unreadable approx frame) or misleads
        # (misOCR'd digit), a second pass rescans the FULL ±search_window
        # around the coarse hit — the pre-compression-fix behavior — so a
        # single bad read cannot drop the target.
        center: int | None = None
        frame = self.video.get_frame(approx_frame)
        if frame is not None:
            ts, _ = self.extractor.extract(frame, approx_frame)
            if ts is not None:
                offset = int(round(self.fps * self._to_video_seconds(
                    abs((target - ts).total_seconds())
                ) * (1 if target >= ts else -1)))
                center = int(np.clip(approx_frame + offset, 0,
                                     max(self.video.frame_count - 1, 0)))
        step_s = min(self.fine_interval,
                     self._to_video_seconds(self.tolerance_seconds / 2))
        narrow_window_s = min(
            self.search_window,
            max(self._to_video_seconds(2 * self.tolerance_seconds),
                3 * step_s),
        )
        passes = []
        if center is not None:
            passes.append((center, narrow_window_s))
        passes.append((approx_frame, self.search_window))  # wide fallback
        for pass_center, window_s in passes:
            sampler = FineSampler(step_s, window_s, self.fps)
            best: ExtractedFrame | None = None
            for fn in sampler.sample_around_target(
                pass_center, self.video.frame_count
            ):
                frame = self.video.get_frame(fn)
                if frame is None:
                    continue
                ts, conf = self.extractor.extract(frame, fn)
                if ts is None:
                    continue
                err = abs((ts - target).total_seconds())
                if err <= self.tolerance_seconds and (
                    best is None or err < best.time_error_seconds
                ):
                    best = ExtractedFrame(
                        frame_number=fn,
                        timestamp=ts,
                        target_timestamp=target,
                        confidence=conf,
                        time_error_seconds=err,
                    )
            if best is not None:
                return best
        return None
