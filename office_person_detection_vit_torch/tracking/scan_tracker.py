"""The scan tracker: a whole sequence associated on the device.

Mirrors ``office_person_detection_vit_tpu/tracking/scan_tracker.py``, whose
``lax.scan`` over frames becomes a loop over frames whose state and inputs
stay on one device: struct-of-arrays track slots of a fixed capacity with an
``active`` mask, the Kalman predict and update over all slots at once, a
fused appearance + IoU cost gated by predicted-position distance, the greedy
assignment on the device (``ops.assignment.greedy_assignment_device``), the
EMA feature and ``min_hits`` confirmation.

Nothing in the loop reads a value back to the host (no ``.item()``, no
boolean-mask indexing, no Python branch on a tensor): the host only enqueues
work, and ``assign_track_ids`` packs the sequence once and reads the ids
back once. The products and norms of the cost run in float64 and are
rounded to float32, and everything else is elementwise, so the card and the
CPU agree bit for bit on the cost, and so on every greedy pick.

The JAX loop that starts new tracks gives each detection to be started the
first free slot in turn; here that is one step: the k-th such detection (in
detection order) takes the k-th free slot (in slot order), while there are
free slots.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import NamedTuple

import numpy as np
import torch

from ..device import full_float32, resolve_device
from ..ops.assignment import greedy_assignment_device
from ..ops.boxes import center_xywh, iou_matrix_xywh
from ..ops.kalman import DEFAULT_INIT_VELOCITY_VAR, kf_predict_batch, kf_update_batch

BIG = 1e9


class TrackState(NamedTuple):
    """Track slots (capacity T), the JAX package's ``TrackState`` fields."""

    kf_x: torch.Tensor     # (T, 4) float32 [px, py, vx, vy] of box centres
    kf_P: torch.Tensor     # (T, 4, 4) float32
    bbox: torch.Tensor     # (T, 4) float32 last matched xywh
    feat: torch.Tensor     # (T, Fd) float32 EMA appearance feature (L2-normalised)
    active: torch.Tensor   # (T,) bool
    age: torch.Tensor      # (T,) int32 frames since the last match
    hits: torch.Tensor     # (T,) int32
    ids: torch.Tensor      # (T,) int32 track ids (0: never assigned)
    next_id: torch.Tensor  # () int32


def init_state(capacity: int, feat_dim: int, device: torch.device | str = "cpu") -> TrackState:
    i32 = dict(dtype=torch.int32, device=device)
    return TrackState(
        kf_x=torch.zeros((capacity, 4), device=device),
        kf_P=torch.eye(4, device=device).repeat(capacity, 1, 1),
        bbox=torch.zeros((capacity, 4), device=device),
        feat=torch.zeros((capacity, feat_dim), device=device),
        active=torch.zeros((capacity,), dtype=torch.bool, device=device),
        age=torch.zeros((capacity,), **i32),
        hits=torch.zeros((capacity,), **i32),
        ids=torch.zeros((capacity,), **i32),
        next_id=torch.ones((), **i32),
    )


def state_from_numpy(arrays: dict, device: torch.device | str = "cpu") -> TrackState:
    """A ``TrackState`` on ``device`` from numpy arrays keyed by field name
    (``state_to_numpy``'s form; the JAX package's state as
    ``{k: np.asarray(v) for k, v in state._asdict().items()}``)."""
    return TrackState(*(torch.from_numpy(np.array(arrays[k])).to(device) for k in TrackState._fields))


def state_to_numpy(state: TrackState) -> dict[str, np.ndarray]:
    """The state's fields as host numpy arrays, keyed by field name."""
    return {k: v.cpu().numpy() for k, v in state._asdict().items()}


def _dot64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (N, F) @ b (M, F)^T summed in float64, rounded to float32."""
    return (a.double() @ b.double().T).float()


def _l2_normalise(x: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x.double(), dim=1, keepdim=True).float()
    return x / norm.clamp(min=1e-12)


def _step(st: TrackState, bx, cf, va, ft, dt, p: dict, p0: torch.Tensor) -> tuple[TrackState, torch.Tensor]:
    """One frame: boxes bx (D, 4), conf cf (D,), valid va (D,), features ft
    (D, Fd), dt (); p the tracker's settings, p0 a new track's covariance ->
    (state, ids (D,) int32, -1 where none)."""
    T = st.active.shape[0]
    D = bx.shape[0]

    # 1. Kalman predict of every slot (inactive slots are masked out below).
    kx, kP = kf_predict_batch(st.kf_x, st.kf_P, dt)
    pred_center = kx[:, :2]
    pred_box = torch.cat([pred_center - st.bbox[:, 2:] / 2, st.bbox[:, 2:]], dim=1)

    # 2. Fused cost on the predicted box, appearance only where both the
    # track and the detection carry a (nonzero) feature; gated by distance,
    # and without features by overlap.
    iou_d = 1.0 - iou_matrix_xywh(pred_box, bx)
    cos_d = 1.0 - _dot64(st.feat, ft)
    det_has = (ft != 0).any(dim=1)
    trk_has = (st.feat != 0).any(dim=1)
    pair_feat = trk_has[:, None] & det_has[None, :]
    cost = torch.where(pair_feat, p["appearance_weight"] * cos_d + p["motion_weight"] * iou_d, iou_d)
    det_center = center_xywh(bx)
    diff = pred_center[:, None, :] - det_center[None, :, :]
    dist = (diff * diff).sum(dim=-1).sqrt()
    gate = (st.active[:, None] & va[None, :] & (dist <= p["max_position_distance"])
            & (pair_feat | (iou_d < 1.0)))
    cost = torch.where(gate, cost, torch.full_like(cost, BIG))

    # 3. Greedy assignment on the device.
    row, det_slot = greedy_assignment_device(cost, max_cost=p["max_cost"])
    matched = row >= 0

    # 4. Matched slots: Kalman update at the detection's centre, EMA feature.
    det_idx = row.long().clamp(0, D - 1)
    ux, uP = kf_update_batch(kx, kP, det_center[det_idx])
    alpha = p["feature_alpha"]
    new_feat = _l2_normalise(alpha * st.feat + (1 - alpha) * ft[det_idx])
    m = matched[:, None]
    kf_x = torch.where(m, ux, kx)
    kf_P = torch.where(m[..., None], uP, kP)
    bbox = torch.where(m, bx[det_idx], st.bbox)
    feat = torch.where(m & det_has[det_idx][:, None], new_feat, st.feat)
    age = torch.where(matched, 0, st.age + 1).to(torch.int32)
    hits = torch.where(matched, st.hits + 1, st.hits).to(torch.int32)
    active = st.active & (age <= p["max_age"])

    # 5. New tracks from unmatched confident detections: the k-th of them
    # takes the k-th free slot.
    needs = va & (det_slot < 0) & (cf >= p["init_conf"])
    free = ~active
    det_rank = torch.cumsum(needs.to(torch.int32), 0) - 1
    slot_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    pair = needs[:, None] & free[None, :] & (det_rank[:, None] == slot_rank[None, :])  # (D, T)
    got_d = pair.any(dim=1)
    got_t = pair.any(dim=0)
    det_of_t = pair.to(torch.int32).argmax(dim=0)
    gt = got_t[:, None]
    new_x = torch.cat([det_center[det_of_t], torch.zeros_like(det_center[det_of_t])], dim=1)
    kf_x = torch.where(gt, new_x, kf_x)
    kf_P = torch.where(gt[..., None], p0, kf_P)
    bbox = torch.where(gt, bx[det_of_t], bbox)
    feat = torch.where(gt, ft[det_of_t], feat)
    active = active | got_t
    age = torch.where(got_t, 0, age).to(torch.int32)
    hits = torch.where(got_t, 1, hits).to(torch.int32)
    ids = torch.where(got_t, st.next_id + slot_rank, st.ids).to(torch.int32)
    next_id = (st.next_id + got_t.sum()).to(torch.int32)
    det_slot = torch.where(got_d, pair.to(torch.int32).argmax(dim=1), det_slot)

    # min_hits confirmation: a detection carries its track's id once the
    # track has enough hits.
    slot_c = det_slot.long().clamp(0, T - 1)
    out = torch.where((det_slot >= 0) & (hits[slot_c] >= p["min_hits"]), ids[slot_c], -1).to(torch.int32)
    return TrackState(kf_x, kf_P, bbox, feat, active, age, hits, ids, next_id), out


def scan_track(state: TrackState, boxes: torch.Tensor, conf: torch.Tensor, valid: torch.Tensor,
               feats: torch.Tensor, dts: torch.Tensor, *, max_age: int = 100, min_hits: int = 1,
               appearance_weight: float = 0.9, motion_weight: float = 0.1, max_cost: float = 0.7,
               init_conf: float = 0.3, feature_alpha: float = 0.9, max_position_distance: float = 10000.0,
               ) -> tuple[TrackState, torch.Tensor]:
    """Track a whole sequence on the state's device: boxes (F, D, 4) xywh,
    conf (F, D), valid (F, D) bool, feats (F, D, Fd) L2-normalised (zeros
    where unused), dts (F,) seconds between frames -> (final state, ids
    (F, D) int32, -1 for unmatched or invalid detections).

    TF32 is off for the whole loop (``device.full_float32``)."""
    p = dict(max_age=max_age, min_hits=min_hits, appearance_weight=appearance_weight, motion_weight=motion_weight,
             max_cost=max_cost, init_conf=init_conf, feature_alpha=feature_alpha,
             max_position_distance=max_position_distance)
    dev = state.active.device
    F, D = conf.shape
    # A new track's covariance diag(10, 10, v, v), made by kernels alone: a
    # value copied from the host (torch.tensor, item assignment) would wait
    # on the device.
    eye = torch.eye(4, device=dev)
    p0 = eye * 10.0 + eye * torch.arange(4, device=dev).ge(2) * (DEFAULT_INIT_VELOCITY_VAR - 10.0)
    ids = torch.empty((F, D), dtype=torch.int32, device=dev)
    with full_float32():
        for f in range(F):
            state, ids[f] = _step(state, boxes[f], conf[f], valid[f], feats[f], dts[f], p, p0)
    return state, ids


def pack_frame_results(frame_results, timestamps: bool = True) -> tuple[np.ndarray, ...]:
    """FrameResults -> host arrays boxes (F, D, 4), conf (F, D), valid (F, D),
    feats (F, D, Fd), dts (F,), as the JAX facade packs them: D is the most
    detections of a frame, Fd the first feature's length (1 without
    features), dt the seconds since the last timestamp (1 without one)."""
    F = len(frame_results)
    D = max((len(fr.detections) for fr in frame_results), default=1) or 1
    feat_dim = next((len(d.feature) for fr in frame_results for d in fr.detections if d.feature is not None), 0)
    Fd = feat_dim or 1
    boxes = np.zeros((F, D, 4), np.float32)
    conf = np.zeros((F, D), np.float32)
    valid = np.zeros((F, D), bool)
    feats = np.zeros((F, D, Fd), np.float32)
    dts = np.ones((F,), np.float32)
    prev_ts = None
    for f, fr in enumerate(frame_results):
        ts = fr.timestamp
        if isinstance(ts, str):  # the record allows ISO strings
            try:
                ts = datetime.fromisoformat(ts)
            except ValueError:
                ts = None
        if timestamps and ts is not None and prev_ts is not None:
            dts[f] = max((ts - prev_ts).total_seconds(), 1e-3)
        if timestamps:
            # A frame without a timestamp advances by the dt charged for it,
            # so the next timestamped frame does not count it twice.
            if ts is not None:
                prev_ts = ts
            elif prev_ts is not None:
                prev_ts = prev_ts + timedelta(seconds=float(dts[f]))
        for d_i, det in enumerate(fr.detections[:D]):
            boxes[f, d_i] = det.bbox
            conf[f, d_i] = det.confidence
            valid[f, d_i] = True
            if feat_dim and det.feature is not None:
                feats[f, d_i] = det.feature
    return boxes, conf, valid, feats, dts


def assign_track_ids(frame_results, capacity: int = 64, timestamps: bool = True, device: str = "auto",
                     **tracker_kw) -> np.ndarray:
    """Pack a FrameResult list on the host, move it to ``device`` (a
    ``detection.device`` value: the card unless ``"cpu"``) once, run the
    scan there, read the ids back once and write ``det.track_id`` in place.
    Returns the (F, D) id matrix."""
    dev = resolve_device(str(device))
    boxes, conf, valid, feats, dts = (torch.from_numpy(a).to(dev)
                                      for a in pack_frame_results(frame_results, timestamps))
    _, ids = scan_track(init_state(capacity, feats.shape[-1], dev), boxes, conf, valid, feats, dts, **tracker_kw)
    ids_np = ids.cpu().numpy()
    D = ids_np.shape[1]
    for f, fr in enumerate(frame_results):
        for d_i, det in enumerate(fr.detections[:D]):
            det.track_id = int(ids_np[f, d_i]) if ids_np[f, d_i] >= 0 else None
    return ids_np
