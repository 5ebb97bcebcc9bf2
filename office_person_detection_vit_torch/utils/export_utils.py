"""Track exports of Phase 2.5.

The ``TrajectoryExporter`` part of
``office_person_detection_vit_tpu/utils/export_utils.py``: ``tracks.csv``,
``tracks_mot.csv`` (MOTChallenge), ``tracks.json`` and ``frames_index.csv``,
the same files as the JAX package writes. The side-by-side video exporter
is not ported (ROADMAP A.3b).
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Sequence

from ..core.dto import FrameResult


class TrajectoryExporter:
    """Per-track trajectories of tracked FrameResults."""

    def __init__(self, output_dir: str | Path):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

    def export_csv(self, frames: Sequence[FrameResult], name: str = "tracks.csv") -> Path:
        """frame,timestamp,track_id,x,y,w,h,confidence: a row for each
        tracked detection."""
        path = self.output_dir / name
        with path.open("w", newline="", encoding="utf-8") as f:
            writer = csv.writer(f)
            writer.writerow(["frame", "timestamp", "track_id", "x", "y", "w", "h", "confidence"])
            for fr in frames:
                for det in fr.detections:
                    if det.track_id is None:
                        continue
                    writer.writerow([fr.frame_number, fr.timestamp_str, det.track_id,
                                     *(f"{v:.1f}" for v in det.bbox[:4]), f"{det.confidence:.3f}"])
        return path

    def export_frame_index(self, frames: Sequence[FrameResult], name: str = "frames_index.csv") -> Path:
        """mot_frame,video_frame,timestamp for every tracked frame, those
        without detections too (they leave no row in the other files), so
        that a MOT scorer can join the 1-based frame ids to wall-clock time."""
        path = self.output_dir / name
        with path.open("w", newline="", encoding="utf-8") as f:
            writer = csv.writer(f)
            writer.writerow(["mot_frame", "video_frame", "timestamp"])
            for idx, fr in enumerate(frames, start=1):
                writer.writerow([idx, fr.frame_number, fr.timestamp_str])
        return path

    def export_mot_csv(self, frames: Sequence[FrameResult], name: str = "tracks_mot.csv") -> Path:
        """MOTChallenge rows frame,id,x,y,w,h,conf,-1,-1,-1 with 1-based
        frame indices."""
        path = self.output_dir / name
        with path.open("w", newline="", encoding="utf-8") as f:
            writer = csv.writer(f)
            for idx, fr in enumerate(frames, start=1):
                for det in fr.detections:
                    if det.track_id is None:
                        continue
                    writer.writerow([idx, det.track_id, *(f"{v:.2f}" for v in det.bbox[:4]),
                                     f"{det.confidence:.3f}", -1, -1, -1])
        return path

    def export_json(self, frames: Sequence[FrameResult], name: str = "tracks.json") -> Path:
        """Each track's trajectory, keyed by track id."""
        tracks: dict[int, dict] = {}
        for fr in frames:
            for det in fr.detections:
                if det.track_id is None:
                    continue
                entry = tracks.setdefault(det.track_id, {"track_id": det.track_id, "trajectory": []})
                point = {
                    "frame": fr.frame_number,
                    "timestamp": fr.timestamp_str,
                    "bbox": [round(float(v), 1) for v in det.bbox],
                    "confidence": round(float(det.confidence), 3),
                }
                if det.floor_coords_mm is not None:
                    point["floor_mm"] = [round(float(v), 1) for v in det.floor_coords_mm]
                entry["trajectory"].append(point)
        path = self.output_dir / name
        path.write_text(json.dumps({"num_tracks": len(tracks), "tracks": list(tracks.values())}, indent=2),
                        encoding="utf-8")
        return path
