"""The cascade tracker: DeepSORT-style appearance, ByteTrack's two stages
and a matching cascade, on the host.

Mirrors ``office_person_detection_vit_tpu/tracking/tracker.py``, the
association stages in the same order:

1. appearance only, high-confidence detections against confirmed tracks
   (cosine distance at most 0.3);
2. weighted appearance + IoU on the rest (at most 0.7);
3. IoU only;
4. ByteTrack's rescue of low-confidence detections, IoU only;
5. tentative tracks, IoU only.

Every stage gates pairs by the distance of the Kalman-predicted position;
the assignment is the exact LAP (``ops.assignment.solve_lap``).
"""

from __future__ import annotations

import logging

import numpy as np

from ..core.dto import Detection
from ..ops.assignment import solve_lap
from .similarity import SimilarityCalculator
from .track import Track, TrackState

logger = logging.getLogger(__name__)

APPEARANCE_GATE = 0.3  # stage-1 cosine-distance acceptance
COMBINED_GATE = 0.7  # stage-2 fused-cost acceptance
HIGH_CONF_THRESHOLD = 0.3  # split for ByteTrack stages
LOW_CONF_FLOOR = 0.1  # detections below this are discarded entirely


class Tracker:
    def __init__(self, max_age: int = 100, min_hits: int = 1, iou_threshold: float = 0.5,
                 appearance_weight: float = 0.9, motion_weight: float = 0.1,
                 max_position_distance: float = 10000.0, high_conf_threshold: float = HIGH_CONF_THRESHOLD):
        self.max_age = int(max_age)
        self.min_hits = int(min_hits)
        self.iou_threshold = float(iou_threshold)
        self.max_position_distance = float(max_position_distance)
        self.high_conf_threshold = float(high_conf_threshold)
        self.similarity = SimilarityCalculator(appearance_weight, motion_weight)
        self.tracks: list[Track] = []
        self._next_id = 1
        self.frame_count = 0

    @classmethod
    def from_config(cls, cfg) -> "Tracker":
        return cls(
            max_age=cfg.get("tracking.max_age", 100),
            min_hits=cfg.get("tracking.min_hits", 1),
            iou_threshold=cfg.get("tracking.iou_threshold", 0.5),
            appearance_weight=cfg.get("tracking.appearance_weight", 0.9),
            motion_weight=cfg.get("tracking.motion_weight", 0.1),
            max_position_distance=cfg.get("tracking.max_position_distance", 10000.0),
        )

    def update(self, detections: list[Detection], timestamp: float | None = None) -> list[Track]:
        """Advance one frame; returns the confirmed tracks."""
        self.frame_count += 1
        for t in self.tracks:
            t.predict(timestamp)

        detections = [d for d in detections if d.confidence >= LOW_CONF_FLOOR]
        high = [d for d in detections if d.confidence >= self.high_conf_threshold]
        low = [d for d in detections if d.confidence < self.high_conf_threshold]

        confirmed = [t for t in self.tracks if t.state == TrackState.CONFIRMED]
        tentative = [t for t in self.tracks if t.state == TrackState.TENTATIVE]

        matches, um_tracks, um_high = self._associate(confirmed, high)

        # Stage 4: ByteTrack rescue, leftover confirmed tracks vs low-confidence.
        rescue, um_tracks, _ = self._match_iou(um_tracks, low, self.iou_threshold)
        matches += rescue

        # Stage 5: tentative tracks vs the remaining high-confidence detections.
        tent_matches, um_tent, um_high = self._match_iou(tentative, um_high, self.iou_threshold)
        matches += tent_matches

        for track, det in matches:
            track.update(det, timestamp)
            det.track_id = track.track_id
        for track in um_tracks + um_tent:
            track.mark_missed(self.max_age)
        for det in um_high:
            self._initiate(det, timestamp)

        self.tracks = [t for t in self.tracks if not t.is_deleted]
        return self.get_confirmed_tracks()

    def get_confirmed_tracks(self) -> list[Track]:
        return [t for t in self.tracks if t.is_confirmed]

    def reset(self) -> None:
        self.tracks = []
        self._next_id = 1
        self.frame_count = 0

    def _initiate(self, det: Detection, timestamp: float | None) -> None:
        self.tracks.append(Track(self._next_id, det, timestamp or 0.0, min_hits=self.min_hits))
        det.track_id = self._next_id
        self._next_id += 1

    def _position_gate(self, tracks: list[Track], dets: list[Detection]) -> np.ndarray:
        """(T, D) bool: True where the pair passes the distance gate."""
        if not tracks or not dets:
            return np.zeros((len(tracks), len(dets)), bool)
        tp = np.asarray([t.predicted_center for t in tracks], np.float32)
        dp = np.asarray([d.center for d in dets], np.float32)
        return self.similarity.position_distance_matrix(tp, dp) <= self.max_position_distance

    @staticmethod
    def _take(pairs: list[tuple[int, int]], cost: np.ndarray, gate: np.ndarray,
              accept: float) -> list[tuple[int, int]]:
        return [(r, c) for r, c in pairs if gate[r, c] and cost[r, c] <= accept]

    def _match_stage(self, rem_t: list[Track], rem_d: list[Detection], combined: bool, accept: float):
        """Stage 1 (appearance) or 2 (``combined``) over the tracks and
        detections that both carry features; returns the matches and what
        is left of ``rem_t`` and ``rem_d``."""
        t_idx = [i for i, t in enumerate(rem_t) if t.get_smoothed_feature() is not None]
        d_idx = [j for j, d in enumerate(rem_d) if d.feature is not None]
        if not (t_idx and d_idx):
            return [], rem_t, rem_d
        sub_t = [rem_t[i] for i in t_idx]
        sub_d = [rem_d[j] for j in d_idx]
        tf = np.stack([t.get_smoothed_feature() for t in sub_t])
        df = np.stack([np.asarray(d.feature, np.float32) for d in sub_d])
        dfn = df / np.maximum(np.linalg.norm(df, axis=1, keepdims=True), 1e-12)
        if combined:
            cost = self.similarity.combined_cost_matrix(
                tf, dfn, np.asarray([t.bbox for t in sub_t], np.float32),
                np.asarray([d.bbox for d in sub_d], np.float32))
        else:
            cost = self.similarity.cosine_distance_matrix(tf, dfn)
        gate = self._position_gate(sub_t, sub_d)
        pairs = self._take(solve_lap(np.where(gate, cost, 1e9)), cost, gate, accept)
        matched_t = {t_idx[r] for r, _ in pairs}
        matched_d = {d_idx[c] for _, c in pairs}
        matches = [(rem_t[t_idx[r]], rem_d[d_idx[c]]) for r, c in pairs]
        return (matches, [t for i, t in enumerate(rem_t) if i not in matched_t],
                [d for j, d in enumerate(rem_d) if j not in matched_d])

    def _associate(self, tracks: list[Track], dets: list[Detection]
                   ) -> tuple[list[tuple[Track, Detection]], list[Track], list[Detection]]:
        """Stages 1-3 over confirmed tracks and high-confidence detections."""
        app, rem_t, rem_d = self._match_stage(list(tracks), list(dets), False, APPEARANCE_GATE)
        comb, rem_t, rem_d = self._match_stage(rem_t, rem_d, True, COMBINED_GATE)
        iou_matches, rem_t, rem_d = self._match_iou(rem_t, rem_d, self.iou_threshold)
        return app + comb + iou_matches, rem_t, rem_d

    def _match_iou(self, tracks: list[Track], dets: list[Detection], iou_threshold: float
                   ) -> tuple[list[tuple[Track, Detection]], list[Track], list[Detection]]:
        if not tracks or not dets:
            return [], list(tracks), list(dets)
        cost = self.similarity.iou_distance_matrix(np.asarray([t.bbox for t in tracks], np.float32),
                                                   np.asarray([d.bbox for d in dets], np.float32))
        gate = self._position_gate(tracks, dets)
        pairs = self._take(solve_lap(np.where(gate, cost, 1e9)), cost, gate, 1.0 - iou_threshold)
        matched_t = {r for r, _ in pairs}
        matched_d = {c for _, c in pairs}
        return ([(tracks[r], dets[c]) for r, c in pairs],
                [t for i, t in enumerate(tracks) if i not in matched_t],
                [d for j, d in enumerate(dets) if j not in matched_d])
