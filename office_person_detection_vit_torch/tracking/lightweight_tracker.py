"""The hybrid tracker: greedy IoU matching on frames with detections,
optical flow or a Kalman prediction on frames without.

Mirrors ``office_person_detection_vit_tpu/tracking/lightweight_tracker.py``:
ByteTrack-style greedy IoU association (``ops.assignment.greedy_assignment``)
where there are detections; where there are none, box centres move by
Lucas-Kanade sparse optical flow (OpenCV, host), with the Kalman prediction
where the flow fails or is off.
"""

from __future__ import annotations

import logging

import numpy as np

from ..core.dto import Detection
from ..ops import kalman
from ..ops.assignment import greedy_assignment
from .similarity import SimilarityCalculator

logger = logging.getLogger(__name__)

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


class _LightTrack:
    def __init__(self, track_id: int, det: Detection, timestamp: float):
        self.track_id = track_id
        self.bbox = tuple(det.bbox)
        self.confidence = float(det.confidence)
        cx, cy = det.center
        self.kf = kalman.kf_init_np(np.asarray([cx, cy], np.float32))
        self.time_since_update = 0
        self.hits = 1
        self.trajectory: list[tuple[float, tuple[float, float, float, float]]] = [(timestamp, self.bbox)]
        self.interpolated: bool = False

    def shift_to(self, cx: float, cy: float, timestamp: float, interpolated: bool) -> None:
        x, y, w, h = self.bbox
        self.bbox = (cx - w / 2.0, cy - h / 2.0, w, h)
        self.trajectory.append((timestamp, self.bbox))
        self.interpolated = interpolated


class OpticalFlowTracker:
    """Lucas-Kanade tracking of box centres."""

    def __init__(self):
        self.prev_gray: np.ndarray | None = None

    def set_reference(self, frame: np.ndarray) -> None:
        if _HAS_CV2:
            self.prev_gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)

    def flow_points(self, frame: np.ndarray, points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(N, 2) points of the reference frame -> (new points, success mask)."""
        if not _HAS_CV2 or self.prev_gray is None or len(points) == 0:
            return points, np.zeros(len(points), bool)
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        p0 = points.astype(np.float32).reshape(-1, 1, 2)
        p1, status, _ = cv2.calcOpticalFlowPyrLK(
            self.prev_gray, gray, p0, None, winSize=(21, 21), maxLevel=3,
            criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 30, 0.01),
        )
        self.prev_gray = gray
        return p1.reshape(-1, 2), status.reshape(-1).astype(bool)


class LightweightTracker:
    def __init__(self, iou_threshold: float = 0.3, max_age: int = 30, use_optical_flow: bool = True):
        self.iou_threshold = float(iou_threshold)
        self.max_age = int(max_age)
        self.use_optical_flow = bool(use_optical_flow) and _HAS_CV2
        self.flow = OpticalFlowTracker()
        self.tracks: list[_LightTrack] = []
        self._next_id = 1

    def update_with_detections(self, detections: list[Detection], frame: np.ndarray | None = None,
                               timestamp: float = 0.0) -> list[_LightTrack]:
        """A frame with detections: greedy IoU association."""
        if frame is not None and self.use_optical_flow:
            self.flow.set_reference(frame)

        if self.tracks and detections:
            cost = 1.0 - SimilarityCalculator.iou_matrix(np.asarray([t.bbox for t in self.tracks], np.float32),
                                                         np.asarray([d.bbox for d in detections], np.float32))
            pairs = greedy_assignment(cost, max_cost=1.0 - self.iou_threshold)
        else:
            pairs = []

        matched_t = {r for r, _ in pairs}
        matched_d = {c for _, c in pairs}
        for r, c in pairs:
            t = self.tracks[r]
            det = detections[c]
            t.bbox = tuple(det.bbox)
            t.confidence = float(det.confidence)
            cx, cy = det.center
            t.kf = kalman.kf_predict_np(t.kf, 1.0)
            t.kf = kalman.kf_update_np(t.kf, np.asarray([cx, cy], np.float32))
            t.time_since_update = 0
            t.hits += 1
            t.trajectory.append((timestamp, t.bbox))
            t.interpolated = False
            det.track_id = t.track_id

        for i, t in enumerate(self.tracks):
            if i not in matched_t:
                t.time_since_update += 1
        for j, det in enumerate(detections):
            if j not in matched_d:
                self.tracks.append(_LightTrack(self._next_id, det, timestamp))
                det.track_id = self._next_id
                self._next_id += 1

        self.tracks = [t for t in self.tracks if t.time_since_update <= self.max_age]
        return list(self.tracks)

    def interpolate(self, frame: np.ndarray | None = None, timestamp: float = 0.0) -> list[_LightTrack]:
        """A frame without detections: boxes move by optical flow, or by the
        Kalman prediction where the flow fails."""
        if not self.tracks:
            return []
        centers = np.asarray([(t.bbox[0] + t.bbox[2] / 2, t.bbox[1] + t.bbox[3] / 2) for t in self.tracks],
                             np.float32)
        ok = np.zeros(len(self.tracks), bool)
        new_pts = centers
        if self.use_optical_flow and frame is not None:
            new_pts, ok = self.flow.flow_points(frame, centers)

        for i, t in enumerate(self.tracks):
            if ok[i]:
                cx, cy = float(new_pts[i, 0]), float(new_pts[i, 1])
                # The filter follows the flow, so that a later flow failure
                # does not snap the box back to the last detection.
                t.kf = kalman.kf_predict_np(t.kf, 1.0)
                t.kf = kalman.kf_update_np(t.kf, np.asarray([cx, cy], np.float32))
            else:
                t.kf = kalman.kf_predict_np(t.kf, 1.0)
                pos = np.asarray(kalman.kf_position(t.kf))
                cx, cy = float(pos[0]), float(pos[1])
            t.shift_to(cx, cy, timestamp, interpolated=True)
        return list(self.tracks)

    def reset(self) -> None:
        self.tracks = []
        self._next_id = 1
