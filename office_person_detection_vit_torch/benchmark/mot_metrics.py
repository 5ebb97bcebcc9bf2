"""MOT metrics: MOTA, IDF1, IDP, IDR, ID switches, and HOTA, on the host.

Mirrors ``office_person_detection_vit_tpu/benchmark/mot_metrics.py``: the
CLEAR-MOT events (Bernardin & Stiefelhagen 2008) with motmetrics'
per-frame continuation and a LAP on the IoU distance with a 0.5 cut-off,
the identity metrics (Ristani et al. 2016) from one trajectory-level LAP,
and HOTA (Luiten et al. 2021) as TrackEval computes it. The loaders read
MOTChallenge CSV (``tracks_mot.csv``) and gold-GT JSON. The per-frame IoU
matrices are small and ragged, so everything runs in numpy.
"""

from __future__ import annotations

import csv
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np

from ..ops.assignment import solve_lap
from ..ops.boxes import iou_matrix_xywh_np

IOU_CUTOFF = 0.5


#: frame -> list of (track_id, xywh bbox)
FrameAnnotations = dict[int, list[tuple[int, tuple[float, float, float, float]]]]


@dataclass
class MOTResult:
    mota: float
    idf1: float
    idp: float
    idr: float
    idsw: int
    fp: int
    fn: int
    num_objects: int
    num_frames: int

    def to_dict(self) -> dict[str, Any]:
        return {
            "mota": self.mota,
            "idf1": self.idf1,
            "idp": self.idp,
            "idr": self.idr,
            "id_switches": self.idsw,
            "false_positives": self.fp,
            "false_negatives": self.fn,
            "num_objects": self.num_objects,
            "num_frames": self.num_frames,
        }


def _iou_matrix(gt_boxes: np.ndarray, hyp_boxes: np.ndarray) -> np.ndarray:
    """Host numpy IoU of xywh boxes (both sides non-empty)."""
    return iou_matrix_xywh_np(gt_boxes.astype(np.float32), hyp_boxes.astype(np.float32))


def _iou_distance(gt_boxes: np.ndarray, hyp_boxes: np.ndarray) -> np.ndarray:
    """1 - IoU, with pairs under the cutoff set to inf (unmatchable)."""
    iou = _iou_matrix(gt_boxes, hyp_boxes)
    dist = 1.0 - iou
    dist[iou < IOU_CUTOFF] = np.inf
    return dist


def evaluate_mot(
    gt: FrameAnnotations,
    hyp: FrameAnnotations,
    events_out: dict[str, list] | None = None,
) -> MOTResult:
    """CLEAR-MOT + identity metrics over the union of frames.

    When ``events_out`` is given it is filled with per-event diagnostics in
    the reference's committed JSONL row shapes (diagnostics/
    id_switches.jsonl / missed_detections.jsonl / false_positives.jsonl):
    ``id_switches`` (old/new hyp id for a GT), ``missed_detections`` (FN GT
    boxes per frame), ``false_positives`` (unmatched hyp boxes per frame).
    Event rows carry the 1-based evaluation FrameId under the key
    ``frame_idx`` — the reference's own committed diagnostics do exactly
    this (its missed_detections.jsonl row for the gold-GT box at frame_idx
    4 reads "frame_idx": 5), i.e. the key name is inherited but the value
    is the MOT frame id, one above the gold JSON's 0-based frame_idx.
    """
    if events_out is not None:
        events_out.setdefault("id_switches", [])
        events_out.setdefault("missed_detections", [])
        events_out.setdefault("false_positives", [])
    frames = sorted(set(gt) | set(hyp))
    last_match: dict[int, int] = {}  # gt id -> last hyp id matched
    fp = fn = idsw = num_objects = 0
    # Identity bookkeeping: per (gt_id, hyp_id) count of frames where the
    # pair is matchable; per-id total frame counts.
    pair_overlap: dict[tuple[int, int], int] = defaultdict(int)
    gt_frames: dict[int, int] = defaultdict(int)
    hyp_frames: dict[int, int] = defaultdict(int)

    for f in frames:
        gt_list = gt.get(f, [])
        hyp_list = hyp.get(f, [])
        num_objects += len(gt_list)
        for gid, _ in gt_list:
            gt_frames[gid] += 1
        for hid, _ in hyp_list:
            hyp_frames[hid] += 1

        if gt_list and hyp_list:
            dist = _iou_distance(
                np.asarray([b for _, b in gt_list]),
                np.asarray([b for _, b in hyp_list]),
            )
            # Identity overlaps (any matchable pair counts).
            finite = np.isfinite(dist)
            for gi, (gid, _) in enumerate(gt_list):
                for hi, (hid, _) in enumerate(hyp_list):
                    if finite[gi, hi]:
                        pair_overlap[(gid, hid)] += 1

            # motmetrics-style continuation: keep last frame's (gt, hyp)
            # correspondence when still matchable, then LAP on the rest.
            matches: dict[int, int] = {}  # gt index -> hyp index
            used_h: set[int] = set()
            hyp_index = {hid: hi for hi, (hid, _) in enumerate(hyp_list)}
            for gi, (gid, _) in enumerate(gt_list):
                prev_h = last_match.get(gid)
                if prev_h is not None and prev_h in hyp_index:
                    hi = hyp_index[prev_h]
                    if np.isfinite(dist[gi, hi]) and hi not in used_h:
                        matches[gi] = hi
                        used_h.add(hi)
            free_g = [gi for gi in range(len(gt_list)) if gi not in matches]
            free_h = [hi for hi in range(len(hyp_list)) if hi not in used_h]
            if free_g and free_h:
                sub = dist[np.ix_(free_g, free_h)]
                for r, c in solve_lap(sub):
                    if np.isfinite(sub[r, c]):
                        matches[free_g[r]] = free_h[c]

            for gi, hi in matches.items():
                gid = gt_list[gi][0]
                hid = hyp_list[hi][0]
                prev = last_match.get(gid)
                if prev is not None and prev != hid:
                    idsw += 1
                    if events_out is not None:
                        events_out["id_switches"].append(
                            {
                                "frame_idx": int(f),
                                "old_track_id": int(prev),
                                "new_track_id": int(hid),
                                "gt_id": int(gid),
                                "bbox": [float(v) for v in gt_list[gi][1]],
                                "iou": float(1.0 - dist[gi, hi]),
                            }
                        )
                last_match[gid] = hid
            fn += len(gt_list) - len(matches)
            fp += len(hyp_list) - len(matches)
            if events_out is not None:
                for gi, (gid, bb) in enumerate(gt_list):
                    if gi not in matches:
                        events_out["missed_detections"].append(
                            {"frame_idx": int(f), "gt_id": int(gid),
                             "bbox": [float(v) for v in bb]}
                        )
                matched_h = set(matches.values())
                for hi, (hid, bb) in enumerate(hyp_list):
                    if hi not in matched_h:
                        events_out["false_positives"].append(
                            {"frame_idx": int(f), "pred_id": int(hid),
                             "bbox": [float(v) for v in bb]}
                        )
        else:
            fn += len(gt_list)
            fp += len(hyp_list)
            if events_out is not None:
                for gid, bb in gt_list:
                    events_out["missed_detections"].append(
                        {"frame_idx": int(f), "gt_id": int(gid),
                         "bbox": [float(v) for v in bb]}
                    )
                for hid, bb in hyp_list:
                    events_out["false_positives"].append(
                        {"frame_idx": int(f), "pred_id": int(hid),
                         "bbox": [float(v) for v in bb]}
                    )

    # ------------------------------------------------------- identity (ID*)
    gids = sorted(gt_frames)
    hids = sorted(hyp_frames)
    total_gt = sum(gt_frames.values())
    total_hyp = sum(hyp_frames.values())
    idtp = 0
    if gids and hids:
        # Ristani padded-square construction: leaving a trajectory unmatched
        # must be an explicit option (cost = its full frame count), otherwise
        # the LAP prefers pairing a GT with a short barely-overlapping hyp
        # just because that hyp has few frames. Square size (G+H):
        #   [ pair cost (fn+fp) | gt-unmatched diag (gt frames) ]
        #   [ hyp-unmatched diag (hyp frames) | zeros            ]
        G, Hn = len(gids), len(hids)
        big = np.full((G + Hn, G + Hn), np.inf)
        for i, gid in enumerate(gids):
            for j, hid in enumerate(hids):
                ov = pair_overlap.get((gid, hid), 0)
                big[i, j] = (gt_frames[gid] - ov) + (hyp_frames[hid] - ov)
        for i, gid in enumerate(gids):
            big[i, Hn + i] = gt_frames[gid]
        for j, hid in enumerate(hids):
            big[G + j, j] = hyp_frames[hid]
        big[G:, Hn:] = 0.0
        for r, c in solve_lap(big):
            if r < G and c < Hn:
                idtp += pair_overlap.get((gids[r], hids[c]), 0)
    idp = idtp / total_hyp if total_hyp else 0.0
    idr = idtp / total_gt if total_gt else 0.0
    idf1 = 2 * idtp / (total_gt + total_hyp) if (total_gt + total_hyp) else 0.0

    mota = 1.0 - (fn + fp + idsw) / num_objects if num_objects else 0.0
    return MOTResult(
        mota=mota,
        idf1=idf1,
        idp=idp,
        idr=idr,
        idsw=idsw,
        fp=fp,
        fn=fn,
        num_objects=num_objects,
        num_frames=len(frames),
    )


# ---------------------------------------------------------------- loaders
def load_mot_csv(path: str | Path) -> FrameAnnotations:
    """MOTChallenge CSV: frame,id,x,y,w,h,conf,... (reference
    mot_metrics.py:136-148; also accepts center-point rows by synthesizing
    a nominal box)."""
    out: FrameAnnotations = defaultdict(list)
    with Path(path).open() as f:
        for row in csv.reader(f):
            if not row or row[0].startswith(("frame", "#")):
                continue
            frame, tid = int(float(row[0])), int(float(row[1]))
            vals = [float(v) for v in row[2:6]]
            if vals[2] <= 0 or vals[3] <= 0:  # center-point rows
                cx, cy = vals[0], vals[1]
                vals = [cx - 25.0, cy - 65.0, 50.0, 130.0]
            out[frame].append((tid, (vals[0], vals[1], vals[2], vals[3])))
    return dict(out)


def load_gold_gt(path: str | Path) -> FrameAnnotations:
    """Gold-GT tracking JSON (reference tracking_benchmark.py:300-347):
    {frames: [{frame_number|frame|frame_idx,
               annotations|tracks: [{track_id|person_id, bbox}]}]}.

    The reference's own committed ``output/ground_truth/gt_tracking.json``
    uses ``frame_idx``/``person_id`` key names; accept those too.
    ``frame_idx`` is 0-based and maps to the 1-based MOTChallenge frame id
    (reference tracking_benchmark.py:332 "FrameId: frame_idx + 1"), matching
    its committed CSV twin (json frame_idx 4 == csv frame 5)."""
    import json

    doc = json.loads(Path(path).read_text())
    out: FrameAnnotations = defaultdict(list)
    frames = doc.get("frames", doc if isinstance(doc, list) else [])
    for fdoc in frames:
        if "frame_number" in fdoc or "frame" in fdoc:
            frame = int(fdoc.get("frame_number", fdoc.get("frame", 0)))
        else:
            frame = int(fdoc.get("frame_idx", 0)) + 1  # 0-based -> MOT 1-based
        for ann in fdoc.get("annotations", fdoc.get("tracks", [])):
            bbox = ann["bbox"]
            if isinstance(bbox, dict):
                bb = (bbox["x"], bbox["y"], bbox["width"], bbox["height"])
            else:
                bb = tuple(float(v) for v in bbox)
            # reference tracking_benchmark.py:327 accepts person_id then id;
            # keep that fallback chain so upstream gold-GT files load drop-in.
            tid = ann.get("track_id", ann.get("person_id", ann.get("id")))
            if tid is None:
                raise KeyError(f"annotation missing track_id/person_id/id: {ann}")
            out[frame].append((int(tid), bb))
    return dict(out)


# ------------------------------------------------------------------- HOTA
@dataclass
class HOTAResult:
    hota: float          # mean over alpha of sqrt(DetA * AssA)
    det_a: float         # mean detection accuracy over alpha
    ass_a: float         # mean association accuracy over alpha
    per_alpha: dict[float, dict[str, float]]

    def to_dict(self) -> dict[str, Any]:
        return {
            "hota": self.hota,
            "det_a": self.det_a,
            "ass_a": self.ass_a,
            "per_alpha": {f"{a:.2f}": v for a, v in self.per_alpha.items()},
        }


def evaluate_hota(
    gt: FrameAnnotations,
    hyp: FrameAnnotations,
    alphas: tuple[float, ...] = tuple(round(0.05 + 0.05 * i, 2) for i in range(19)),
) -> HOTAResult:
    """Higher-Order Tracking Accuracy (Luiten et al., IJCV 2021), following
    the TrackEval reference algorithm: per alpha, (1) count potential id-pair
    overlaps to get a global alignment (Jaccard) score, (2) per-frame
    Hungarian maximizing global alignment (IoU as tie-break) over pairs with
    IoU >= alpha, (3) DetA from TP/FN/FP counts and AssA as the TP-weighted
    mean of TPA / (TPA + FNA + FPA) over matched id pairs."""
    frames = sorted(set(gt) | set(hyp))
    # Precompute per-frame IoU matrices + id lists once (shared across alphas).
    per_frame: list[tuple[list[int], list[int], np.ndarray]] = []
    gt_frames: dict[int, int] = defaultdict(int)
    hyp_frames: dict[int, int] = defaultdict(int)
    total_gt = total_hyp = 0
    for f in frames:
        gt_list = gt.get(f, [])
        hyp_list = hyp.get(f, [])
        total_gt += len(gt_list)
        total_hyp += len(hyp_list)
        for gid, _ in gt_list:
            gt_frames[gid] += 1
        for hid, _ in hyp_list:
            hyp_frames[hid] += 1
        if gt_list and hyp_list:
            iou = _iou_matrix(
                np.asarray([b for _, b in gt_list]),
                np.asarray([b for _, b in hyp_list]),
            )
        else:
            iou = np.zeros((len(gt_list), len(hyp_list)), np.float32)
        per_frame.append(
            ([gid for gid, _ in gt_list], [hid for hid, _ in hyp_list], iou)
        )

    per_alpha: dict[float, dict[str, float]] = {}
    for alpha in alphas:
        # Pass 1: potential id-pair overlaps at this alpha.
        potential: dict[tuple[int, int], int] = defaultdict(int)
        for gids, hids, iou in per_frame:
            ok = iou >= alpha
            for gi, gid in enumerate(gids):
                for hi, hid in enumerate(hids):
                    if ok[gi, hi]:
                        potential[(gid, hid)] += 1
        # Global alignment score (Jaccard over id pairs).
        def align(gid: int, hid: int) -> float:
            p = potential.get((gid, hid), 0)
            return p / max(gt_frames[gid] + hyp_frames[hid] - p, 1)

        # Pass 2: per-frame matching maximizing alignment (IoU tie-break).
        match_count: dict[tuple[int, int], int] = defaultdict(int)
        tp = 0
        for gids, hids, iou in per_frame:
            if not gids or not hids:
                continue
            score = np.zeros_like(iou)
            for gi, gid in enumerate(gids):
                for hi, hid in enumerate(hids):
                    if iou[gi, hi] >= alpha:
                        score[gi, hi] = align(gid, hid) + iou[gi, hi] * 1e-3 + 1e-6
            # maximize score -> minimize negated; zero score = unmatchable
            cost = np.where(score > 0, 1.0 - score, np.inf)
            for gi, hi in solve_lap(cost):
                if np.isfinite(cost[gi, hi]):
                    match_count[(gids[gi], hids[hi])] += 1
                    tp += 1
        fn = total_gt - tp
        fp = total_hyp - tp
        det_a = tp / max(tp + fn + fp, 1)
        # Pass 3: association accuracy, TP-weighted.
        ass_sum = 0.0
        for (gid, hid), tpa in match_count.items():
            fna = gt_frames[gid] - tpa
            fpa = hyp_frames[hid] - tpa
            ass_sum += tpa * (tpa / max(tpa + fna + fpa, 1))
        ass_a = ass_sum / tp if tp else 0.0
        per_alpha[alpha] = {
            "hota": float(np.sqrt(det_a * ass_a)),
            "det_a": det_a,
            "ass_a": ass_a,
        }

    hota = float(np.mean([v["hota"] for v in per_alpha.values()]))
    det_a = float(np.mean([v["det_a"] for v in per_alpha.values()]))
    ass_a = float(np.mean([v["ass_a"] for v in per_alpha.values()]))
    return HOTAResult(hota=hota, det_a=det_a, ass_a=ass_a, per_alpha=per_alpha)
