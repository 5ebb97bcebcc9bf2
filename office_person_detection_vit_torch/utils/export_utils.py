"""Track and video exports (reference src/utils/export_utils.py:30-776).

Mirrors ``office_person_detection_vit_tpu/utils/export_utils.py``, host-side
OpenCV over pipeline artifacts only:

* :class:`TrajectoryExporter`: tracked frame results -> ``tracks.csv``,
  ``tracks_mot.csv`` (MOTChallenge), ``tracks.json``, ``frames_index.csv``,
  an annotated image sequence and an MP4, the same files as the JAX package
  writes;
* :class:`SideBySideVideoExporter`: detection images paired with floormap
  images by the timestamp token of their names, stacked side by side into
  one MP4 (Phase 5's ``output.save_side_by_side_video``), the floormap
  optionally cropped and zoomed around each frame's floor points.
"""

from __future__ import annotations

import csv
import json
import logging
import re
from pathlib import Path
from typing import Sequence

import cv2
import numpy as np

from ..core.dto import FrameResult
from .image_utils import draw_detections

logger = logging.getLogger(__name__)


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

    # --------------------------------------------------------------- imagery
    def export_image_sequence(
        self,
        frames: Sequence[FrameResult],
        images: Sequence[np.ndarray],
        prefix: str = "tracked",
    ) -> list[Path]:
        paths = []
        for fr, img in zip(frames, images):
            out = self.output_dir / f"{prefix}_{fr.frame_number:06d}.jpg"
            cv2.imwrite(str(out), draw_detections(img, fr.detections, draw_track_ids=True))
            paths.append(out)
        return paths

    def export_video(
        self,
        frames: Sequence[FrameResult],
        images: Sequence[np.ndarray],
        name: str = "tracks.mp4",
        fps: float = 2.0,
    ) -> Path | None:
        if not images:
            return None
        h, w = images[0].shape[:2]
        path = self.output_dir / name
        writer = cv2.VideoWriter(
            str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
        )
        try:
            for fr, img in zip(frames, images):
                writer.write(draw_detections(img, fr.detections, draw_track_ids=True))
        finally:
            writer.release()
        return path


_TS_PATTERN = re.compile(r"(\d{8}[_-]?\d{6}|\d{6})")


def _timestamp_key(path: Path) -> str:
    """Timestamp-ish token from a filename for pairing (reference :350-430)."""
    m = _TS_PATTERN.search(path.stem)
    return m.group(1) if m else path.stem


class SideBySideVideoExporter:
    """Pair detection images with floormap images by timestamp token and
    write an hstacked MP4 (reference export_utils.py:587-776)."""

    def __init__(self, fps: float = 2.0, height: int = 720):
        self.fps = fps
        self.height = height

    def _resize_to_height(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        if h == self.height:
            return img
        scale = self.height / h
        return cv2.resize(img, (int(round(w * scale)), self.height))

    @staticmethod
    def crop_and_zoom_floormap(
        floormap_image: np.ndarray,
        floor_points: Sequence[tuple[float, float]],
        zoom_margin: float = 0.8,
        min_zoom_ratio: float = 0.5,
        target_size: tuple[int, int] | None = None,
    ) -> np.ndarray:
        """Crop the floormap around the detections' floor points with a
        margin, never zooming past ``min_zoom_ratio`` of the full map
        (reference export_utils.py:498-584)."""
        h, w = floormap_image.shape[:2]
        pts = [(x, y) for x, y in floor_points if 0 <= x < w and 0 <= y < h]
        if not pts:
            out = floormap_image
        else:
            xs = [p[0] for p in pts]
            ys = [p[1] for p in pts]
            min_x, max_x = max(0.0, min(xs)), min(float(w), max(xs))
            min_y, max_y = max(0.0, min(ys)), min(float(h), max(ys))
            margin_x = (max_x - min_x) * zoom_margin
            margin_y = (max_y - min_y) * zoom_margin
            x1 = max(0, int(min_x - margin_x))
            y1 = max(0, int(min_y - margin_y))
            x2 = min(w, int(max_x + margin_x))
            y2 = min(h, int(max_y + margin_y))
            # Do not zoom in past min_zoom_ratio of the full map: widen the
            # crop around its center (reference :560-575).
            min_w, min_h = int(w * min_zoom_ratio), int(h * min_zoom_ratio)
            if x2 - x1 < min_w:
                cx = (x1 + x2) // 2
                x1 = max(0, cx - min_w // 2)
                x2 = min(w, x1 + min_w)
                if x2 == w:
                    x1 = max(0, w - min_w)
            if y2 - y1 < min_h:
                cy = (y1 + y2) // 2
                y1 = max(0, cy - min_h // 2)
                y2 = min(h, y1 + min_h)
                if y2 == h:
                    y1 = max(0, h - min_h)
            out = floormap_image[y1:y2, x1:x2]
        if target_size is not None:
            out = cv2.resize(out, target_size)
        return out

    def pair_images(
        self, detection_dir: str | Path, floormap_dir: str | Path
    ) -> list[tuple[Path, Path]]:
        det = {
            _timestamp_key(p): p
            for p in sorted(Path(detection_dir).glob("*.jpg"))
        } | {
            _timestamp_key(p): p
            for p in sorted(Path(detection_dir).glob("*.png"))
        }
        fm = {
            _timestamp_key(p): p
            for p in sorted(Path(floormap_dir).glob("*.png"))
        } | {
            _timestamp_key(p): p
            for p in sorted(Path(floormap_dir).glob("*.jpg"))
        }
        keys = sorted(set(det) & set(fm))
        return [(det[k], fm[k]) for k in keys]

    def export(
        self,
        detection_dir: str | Path,
        floormap_dir: str | Path,
        output_path: str | Path,
        floor_points_by_key: dict[str, list[tuple[float, float]]] | None = None,
    ) -> Path | None:
        """Stack timestamp-matched pairs into one MP4. When
        ``floor_points_by_key`` maps a pair's timestamp key to that frame's
        floor points, the floormap side is cropped/zoomed around them
        (reference export_utils.py:498 crop/zoom option)."""
        pairs = self.pair_images(detection_dir, floormap_dir)
        if not pairs:
            logger.warning("no timestamp-matched image pairs; skipping video")
            return None

        def _right(path: Path) -> np.ndarray:
            img = cv2.imread(str(path))
            if floor_points_by_key is not None:
                pts = floor_points_by_key.get(_timestamp_key(path), [])
                img = self.crop_and_zoom_floormap(
                    img, pts, target_size=(img.shape[1], img.shape[0])
                )
            return self._resize_to_height(img)

        first_l = self._resize_to_height(cv2.imread(str(pairs[0][0])))
        first_r = _right(pairs[0][1])
        width = first_l.shape[1] + first_r.shape[1]
        out = Path(output_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        writer = cv2.VideoWriter(
            str(out), cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (width, self.height)
        )
        try:
            for left_path, right_path in pairs:
                left = self._resize_to_height(cv2.imread(str(left_path)))
                right = _right(right_path)
                canvas = np.zeros((self.height, width, 3), np.uint8)
                canvas[:, : left.shape[1]] = left
                canvas[:, left.shape[1] : left.shape[1] + right.shape[1]] = right
                writer.write(canvas)
        finally:
            writer.release()
        logger.info("wrote side-by-side video with %d frames -> %s", len(pairs), out)
        return out
