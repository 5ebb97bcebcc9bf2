"""Floormap rendering (reference src/visualization/floormap_visualizer.py:92-515).

Draws the floormap image (or a blank canvas), translucent zone polygon fills,
the camera marker, per-detection foot-point dots colored by track id, track
trajectories, and a zone-count legend. Pure host OpenCV.

The port's own copy of ``office_person_detection_vit_tpu/visualization/floormap_visualizer.py`` (host code, unchanged).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Sequence

import cv2
import numpy as np

from ..core.dto import Detection, FrameResult
from ..transform.floormap_config import FloorMapConfig
from ..utils.image_utils import track_id_color

logger = logging.getLogger(__name__)

_ZONE_COLORS = [
    (180, 119, 31), (14, 127, 255), (44, 160, 44), (40, 39, 214),
    (189, 103, 148), (75, 86, 140), (194, 119, 227), (127, 127, 127),
]


class FloormapVisualizer:
    def __init__(self, config: Any):
        self.config = config
        self.floormap = FloorMapConfig.from_config(config)
        self.zones = config.get("zones", []) or []
        self.image_path = config.get("floormap.image_path", None)
        self.camera_xy = (
            int(config.get("camera.position_x", 0)),
            int(config.get("camera.position_y", 0)),
        )
        self.show_camera = bool(config.get("camera.show_on_floormap", True))
        self._base: np.ndarray | None = None

    # ---------------------------------------------------------------- base
    def _load_base(self) -> np.ndarray:
        if self._base is None:
            img = None
            if self.image_path and Path(self.image_path).exists():
                img = cv2.imread(str(self.image_path))
            if img is None:
                w = int(self.config.get("floormap.image_width", 1878))
                h = int(self.config.get("floormap.image_height", 1369))
                img = np.full((h, w, 3), 245, np.uint8)
            self._base = img
        return self._base.copy()

    def _draw_zones(self, img: np.ndarray, zone_counts: dict[str, int] | None) -> None:
        overlay = img.copy()
        for i, zone in enumerate(self.zones):
            poly = np.asarray(zone["polygon"], np.int32)
            color = _ZONE_COLORS[i % len(_ZONE_COLORS)]
            cv2.fillPoly(overlay, [poly], color)
            cv2.polylines(img, [poly], True, color, 2)
            cx, cy = poly.mean(axis=0).astype(int)
            label = zone.get("name", zone["id"])
            if zone_counts is not None:
                label = f"{label}: {zone_counts.get(zone['id'], 0)}"
            cv2.putText(img, label, (cx - 30, cy), cv2.FONT_HERSHEY_SIMPLEX,
                        0.7, (30, 30, 30), 2, cv2.LINE_AA)
        cv2.addWeighted(overlay, 0.25, img, 0.75, 0, dst=img)

    def _draw_camera(self, img: np.ndarray) -> None:
        if not self.show_camera:
            return
        color = tuple(int(c) for c in self.config.get("camera.marker_color", [0, 0, 255]))
        size = int(self.config.get("camera.marker_size", 15))
        cv2.drawMarker(img, self.camera_xy, color, cv2.MARKER_TRIANGLE_UP, size * 2, 3)
        cv2.putText(img, "camera", (self.camera_xy[0] + 12, self.camera_xy[1] + 4),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, color, 2, cv2.LINE_AA)

    # --------------------------------------------------------------- frames
    def visualize_frame(
        self,
        frame_result: FrameResult,
        output_path: str | Path | None = None,
        trajectories: dict[int, list[tuple[float, float]]] | None = None,
    ) -> np.ndarray:
        """Floormap + zones + foot points (+ ids/trajectories) for one frame
        (reference :366)."""
        img = self._load_base()
        self._draw_zones(img, frame_result.zone_counts or None)
        self._draw_camera(img)

        if trajectories:
            for tid, pts in trajectories.items():
                if len(pts) < 2:
                    continue
                arr = np.asarray(pts, np.int32)
                cv2.polylines(img, [arr], False, track_id_color(tid), 2, cv2.LINE_AA)

        for det in frame_result.detections:
            if det.floor_coords_px is None:
                continue
            x, y = (int(round(v)) for v in det.floor_coords_px)
            color = (
                track_id_color(det.track_id)
                if det.track_id is not None
                else (60, 60, 220)
            )
            cv2.circle(img, (x, y), 9, color, -1, cv2.LINE_AA)
            cv2.circle(img, (x, y), 9, (255, 255, 255), 2, cv2.LINE_AA)
            if det.track_id is not None:
                cv2.putText(img, str(det.track_id), (x + 10, y - 8),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.6, color, 2, cv2.LINE_AA)

        ts = frame_result.timestamp_str
        if ts:
            cv2.putText(img, ts, (16, 36), cv2.FONT_HERSHEY_SIMPLEX, 1.0,
                        (20, 20, 20), 2, cv2.LINE_AA)
        if output_path is not None:
            out = Path(output_path)
            out.parent.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(out), img)
        return img

    def collect_trajectories(
        self, frame_results: Sequence[FrameResult], up_to: int | None = None
    ) -> dict[int, list[tuple[float, float]]]:
        """Per-track floor-space polylines over the run (for trajectory
        overlays, reference :456+)."""
        traj: dict[int, list[tuple[float, float]]] = {}
        frames = frame_results if up_to is None else frame_results[: up_to + 1]
        for fr in frames:
            for det in fr.detections:
                if det.track_id is None or det.floor_coords_px is None:
                    continue
                traj.setdefault(det.track_id, []).append(det.floor_coords_px)
        return traj
