"""The port's tracking slice (Phase 2.5) against the JAX package, on the CPU.

The same numpy-seeded inputs go through each JAX module and its port:

- Kalman predict and update, batched (torch) and numpy, over several dts:
  each tensor within 1e-5 of max(1, its max |ref|), the updated covariance
  within 1e-5 of max(1, the predicted covariance's max) (the update
  subtracts nearly equal products, so the rounding of both float32 forms is
  read against the scale of its input); the numpy forms exactly;
- both greedy forms and ``solve_lap`` on costs with inf, N != M and a
  ``max_cost``: the same pairs and assignments;
- the similarity matrices: 1e-6 absolute;
- the cascade and the hybrid tracker on seeded sequences with and without
  features and with timestamp gaps: identical track ids;
- ``scan_track`` (the JAX scan run as ``tests/test_scan_tracker.py`` runs it,
  on the CPU) with ``min_hits`` 1 and 3, features on and off, a capacity
  overflow and a resume through ``state_from_numpy``: identical (F, D) ids,
  the final state within 1e-4 of max(1, each field's max |ref|);
- the ReID histogram and ``clip`` cases (the ``detr`` backend is in
  ``tests/test_torch_features.py``, beside the DETR-small detectors);
- ``TrajectoryExporter``'s four files and ``TrackingPhase`` with each engine:
  the same files and ``tracking_statistics.json``; the dense-tracking
  windows and their dedup through Phase 4's ``zone_counts.csv``;
- ``mot_metrics``: the same MOT and HOTA dicts, events and loaders.
"""

import logging
from datetime import datetime, timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.benchmark import mot_metrics as port_mot
from office_person_detection_vit_torch.core import dto as port_dto
from office_person_detection_vit_torch.ops import assignment as port_assign
from office_person_detection_vit_torch.ops import boxes as port_boxes
from office_person_detection_vit_torch.ops import kalman as port_kalman
from office_person_detection_vit_torch.pipeline.phases.aggregation import AggregationPhase
from office_person_detection_vit_torch.pipeline.phases.tracking import TrackingPhase
from office_person_detection_vit_torch.tracking import lightweight_tracker as port_light
from office_person_detection_vit_torch.tracking import reid_feature_extractor as port_reid
from office_person_detection_vit_torch.tracking import scan_tracker as port_scan
from office_person_detection_vit_torch.tracking import similarity as port_sim
from office_person_detection_vit_torch.tracking import tracker as port_tracker
from office_person_detection_vit_torch.utils.export_utils import TrajectoryExporter
from office_person_detection_vit_tpu.benchmark import mot_metrics as jax_mot
from office_person_detection_vit_tpu.core import dto as jax_dto
from office_person_detection_vit_tpu.ops import assignment as jax_assign
from office_person_detection_vit_tpu.ops import boxes as jax_boxes
from office_person_detection_vit_tpu.ops import kalman as jax_kalman
from office_person_detection_vit_tpu.pipeline.phases.aggregation import AggregationPhase as JaxAggregationPhase
from office_person_detection_vit_tpu.pipeline.phases.tracking import TrackingPhase as JaxTrackingPhase
from office_person_detection_vit_tpu.tracking import lightweight_tracker as jax_light
from office_person_detection_vit_tpu.tracking import reid_feature_extractor as jax_reid
from office_person_detection_vit_tpu.tracking import scan_tracker as jax_scan
from office_person_detection_vit_tpu.tracking import similarity as jax_sim
from office_person_detection_vit_tpu.tracking import tracker as jax_tracker
from office_person_detection_vit_tpu.utils.export_utils import TrajectoryExporter as JaxTrajectoryExporter
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

T0 = datetime(2025, 1, 20, 9, 0, 0)
PACKAGES = {"port": port_dto, "jax": jax_dto}


def scaled_err(got, want, scale=None) -> float:
    """max |got - want| over max(1, max |scale|), ``scale`` ``want`` unless given."""
    want = np.asarray(want, np.float64)
    scale = want if scale is None else np.asarray(scale, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(1.0, np.abs(scale).max()))


# ------------------------------------------------------------------ kalman
@pytest.mark.parametrize("dt", [1e-3, 0.5, 1.0, 10.0, 300.0])
def test_kalman_matches_jax(dt):
    rng = np.random.default_rng(0)
    T = 7
    z = rng.normal(0, 300, (T, 2)).astype(np.float32)
    states = []  # the states of tracks that a few seeded observations moved
    for i in range(T):
        st = jax_kalman.kf_init_np(z[i])
        for step_dt in (0.5, dt, 2.0)[: i % 4]:
            st = jax_kalman.kf_predict_np(st, step_dt)
            st = jax_kalman.kf_update_np(st, z[i] + rng.normal(0, 20, 2).astype(np.float32))
        states.append(st)
    x = np.stack([st.x for st in states]).astype(np.float32)
    P = np.stack([st.P for st in states]).astype(np.float32)
    z = z + rng.normal(0, 30, (T, 2)).astype(np.float32)
    want = jax_kalman.kf_predict_batch(jax_kalman.KFState(jnp.asarray(x), jnp.asarray(P)),
                                       jnp.full((T,), dt, jnp.float32))
    px, pP = port_kalman.kf_predict_batch(torch.from_numpy(x), torch.from_numpy(P), torch.tensor(dt))
    assert scaled_err(px, want.x) <= 1e-5 and scaled_err(pP, want.P) <= 1e-5
    px, pP = (np.array(a) for a in want)
    want_u = jax_kalman.kf_update_batch(want, jnp.asarray(z))
    ux, uP = port_kalman.kf_update_batch(torch.from_numpy(px), torch.from_numpy(pP), torch.from_numpy(z))
    assert scaled_err(ux, want_u.x) <= 1e-5 and scaled_err(uP, want_u.P, scale=pP) <= 1e-5

    for i in range(T):  # the numpy forms: the same numpy operations
        got = port_kalman.kf_update_np(port_kalman.kf_predict_np(port_kalman.KFState(x[i], P[i]), dt), z[i])
        ref = jax_kalman.kf_update_np(jax_kalman.kf_predict_np(jax_kalman.KFState(x[i], P[i]), dt), z[i])
        np.testing.assert_array_equal(got.x, ref.x)
        np.testing.assert_array_equal(got.P, ref.P)
        np.testing.assert_array_equal(port_kalman.kf_init_np(z[i]).P, jax_kalman.kf_init_np(z[i]).P)


# -------------------------------------------------------------- assignment
@pytest.mark.parametrize("shape", [(5, 7), (7, 5), (6, 6), (1, 4), (0, 3)])
@pytest.mark.parametrize("max_cost", [None, 0.3, 0.7])
def test_assignment_matches_jax(shape, max_cost):
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    cost = rng.random(shape).astype(np.float32)
    cost[rng.random(shape) < 0.2] = np.inf
    if cost.size:
        cost[0, -1] = cost.flat[0]  # a tie: the first in row-major order wins
    assert port_assign.greedy_assignment(cost, max_cost) == jax_assign.greedy_assignment(cost, max_cost)
    assert port_assign.solve_lap(cost) == jax_assign.solve_lap(cost)
    assert port_assign.HungarianAlgorithm().solve(cost) == jax_assign.HungarianAlgorithm().solve(cost)
    kw = {} if max_cost is None else {"max_cost": max_cost}
    rows, cols = port_assign.greedy_assignment_device(torch.from_numpy(cost), **kw)
    if cost.size:
        want_r, want_c = jax_assign.greedy_assignment_jit(jnp.asarray(cost), **kw)
    else:  # the JAX form has no empty case; no pair
        want_r, want_c = np.full(shape[0], -1), np.full(shape[1], -1)
    assert rows.dtype == cols.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(want_c))


# -------------------------------------------------------------- similarity
def test_similarity_matches_jax():
    rng = np.random.default_rng(3)
    fa, fb = rng.normal(size=(6, 32)), rng.normal(size=(9, 32))
    fa /= np.linalg.norm(fa, axis=1, keepdims=True)
    fb /= np.linalg.norm(fb, axis=1, keepdims=True)
    ba = np.c_[rng.uniform(0, 500, (6, 2)), rng.uniform(0, 120, (6, 2))].astype(np.float32)
    bb = np.c_[rng.uniform(0, 500, (9, 2)), rng.uniform(0, 120, (9, 2))].astype(np.float32)
    bb[0] = ba[0]
    bb[1, 2:] = 0  # zero area
    port, ref = port_sim.SimilarityCalculator(0.8, 0.2), jax_sim.SimilarityCalculator(0.8, 0.2)
    for name, args in (("cosine_similarity_matrix", (fa, fb)), ("cosine_distance_matrix", (fa, fb)),
                       ("iou_matrix", (ba, bb)), ("iou_distance_matrix", (ba, bb)),
                       ("combined_cost_matrix", (fa, fb, ba, bb)), ("position_distance_matrix", (ba[:, :2], bb[:, :2])),
                       ("iou_matrix", (ba[:0], bb)), ("cosine_similarity_matrix", (fa, fb[:0]))):
        got, want = getattr(port, name)(*args), getattr(ref, name)(*args)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(port_boxes.iou_matrix_xywh(torch.from_numpy(ba), torch.from_numpy(bb)).numpy(),
                               np.asarray(jax_boxes.iou_matrix_xywh(jnp.asarray(ba), jnp.asarray(bb))), atol=1e-6)
    np.testing.assert_array_equal(port_boxes.iou_matrix_xywh_np(ba, bb), jax_boxes.iou_matrix_xywh_np(ba, bb))
    np.testing.assert_array_equal(port_boxes.center_xywh(torch.from_numpy(ba)).numpy(),
                                  np.asarray(jax_boxes.center_xywh(jnp.asarray(ba))))
    with pytest.raises(ValueError):
        port_sim.SimilarityCalculator(0.5, 0.2)


# ------------------------------------------------------- seeded sequences
def walkers(frames: int, people: int, seed: int, feat_dim: int = 16, drop: float = 0.1, fp: int = 1,
            gaps: bool = False, blank: tuple = ()) -> list:
    """Per frame: timestamp and [(xywh, conf, feature or None)]; people walk
    seeded random walks, 10% of detections dropped, ``fp`` false positives a
    frame; ``gaps`` puts 5-minute holes between some frames; frames in
    ``blank`` have no detections."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([50, 50], [560, 300], (people, 2))
    vel = rng.normal(0, 4, (people, 2))
    looks = rng.normal(size=(people, feat_dim))
    out, t = [], T0
    for f in range(frames):
        t += timedelta(seconds=300 if gaps and f % 7 == 3 else 10)
        pos += vel + rng.normal(0, 1.5, pos.shape)
        dets = []
        if f not in blank:
            for p in range(people):
                if rng.random() < drop:
                    continue
                feat = looks[p] + rng.normal(0, 0.2, feat_dim)
                box = (float(pos[p, 0] + rng.normal(0, 1)), float(pos[p, 1] + rng.normal(0, 1)), 30.0, 70.0)
                dets.append((box, float(rng.uniform(0.35, 0.95)), feat / np.linalg.norm(feat)))
            for _ in range(fp):
                box = tuple(float(v) for v in rng.uniform([0, 0, 20, 40], [600, 340, 40, 90]))
                dets.append((box, float(rng.uniform(0.05, 0.5)), None))
            order = rng.permutation(len(dets))
            dets = [dets[i] for i in order]
        out.append((t, dets))
    return out


def frame_results(dto, seq, features: bool = True, str_timestamps: bool = False) -> list:
    """The sequence as FrameResults of one package (fresh Detections)."""
    return [dto.FrameResult(f, t.isoformat() if str_timestamps else t, [
        dto.Detection(bbox=box, confidence=conf, feature=None if (feat is None or not features) else feat.astype(np.float32))
        for box, conf, feat in dets]) for f, (t, dets) in enumerate(seq)]


def render(seq, hw=(360, 640)) -> list:
    """Small frames with each detection drawn as a textured block, so that
    optical flow finds the walkers."""
    import cv2

    frames = []
    for f, (_, dets) in enumerate(seq):
        img = np.full((*hw, 3), 40, np.uint8)
        for i, (box, _, _) in enumerate(dets):
            x, y, w, h = (int(round(v)) for v in box)
            cv2.rectangle(img, (x, y), (x + w, y + h), (60 + 30 * (i % 6), 200, 90 + 20 * i % 160), -1)
            cv2.circle(img, (x + w // 2, y + h // 3), 6, (250, 250, 250), -1)
        frames.append(img)
    return frames


def ids_of(results) -> list:
    return [[d.track_id for d in fr.detections] for fr in results]


@pytest.mark.parametrize("features", [True, False])
@pytest.mark.parametrize("gaps", [False, True])
def test_cascade_matches_jax(features, gaps):
    seq = walkers(30, 6, seed=1 + gaps, gaps=gaps)
    got, want = (frame_results(PACKAGES[k], seq, features) for k in ("port", "jax"))
    for cls, results in ((port_tracker.Tracker, got), (jax_tracker.Tracker, want)):
        tracker = cls.from_config({"tracking.max_age": 4, "tracking.min_hits": 2})
        for fr in results:
            tracker.update(fr.detections, fr.timestamp.timestamp())
    assert ids_of(got) == ids_of(want)
    assert len({i for row in ids_of(got) for i in row if i is not None}) >= 6


@pytest.mark.parametrize("flow", [True, False])
def test_hybrid_matches_jax(flow):
    seq = walkers(16, 4, seed=5, fp=0, blank=(4, 5, 9))
    frames = render(seq)
    out = {}
    for name, module in (("port", port_light), ("jax", jax_light)):
        tracker = module.LightweightTracker(iou_threshold=0.3, max_age=3, use_optical_flow=flow)
        results = frame_results(PACKAGES[name], seq)
        boxes = []
        for fr, frame in zip(results, frames):
            ts = fr.timestamp.timestamp()
            if fr.detections:
                tracker.update_with_detections(fr.detections, frame, ts)
            else:
                boxes.append([(t.track_id, t.bbox, t.interpolated) for t in tracker.interpolate(frame, ts)])
        out[name] = (ids_of(results), boxes)
    assert out["port"][0] == out["jax"][0]
    assert len(out["port"][1]) == 3 and all(out["port"][1])
    for got, want in zip(out["port"][1], out["jax"][1]):
        assert [(i, interp) for i, _, interp in got] == [(i, interp) for i, _, interp in want]
        np.testing.assert_allclose([b for _, b, _ in got], [b for _, b, _ in want], atol=1e-4)


# --------------------------------------------------------------------- scan
def scan_inputs(seq, features: bool):
    return port_scan.pack_frame_results(frame_results(port_dto, seq, features))


@pytest.mark.parametrize("case", ["min_hits_1", "min_hits_3", "no_features", "overflow", "resume"])
def test_scan_matches_jax(case):
    seq = walkers(24, 7, seed=11, fp=2)
    arrays = scan_inputs(seq, features=case != "no_features")
    capacity = 5 if case == "overflow" else 16
    kw = {"min_hits": 3 if case == "min_hits_3" else 1, "max_age": 4}
    feat_dim = arrays[3].shape[-1]
    jax_state, want = jax_scan.scan_track(jax_scan.init_state(capacity, feat_dim), *map(jnp.asarray, arrays), **kw)
    if case == "resume":  # the JAX scan's state half way through, carried into the port
        half = len(seq) // 2
        mid, first = jax_scan.scan_track(jax_scan.init_state(capacity, feat_dim),
                                         *(jnp.asarray(a[:half]) for a in arrays), **kw)
        state = port_scan.state_from_numpy({k: np.asarray(v) for k, v in mid._asdict().items()})
        state, rest = port_scan.scan_track(state, *(torch.from_numpy(a[half:]) for a in arrays), **kw)
        got = np.concatenate([np.asarray(first), rest.numpy()])
    else:
        state, got = port_scan.scan_track(port_scan.init_state(capacity, feat_dim), *map(torch.from_numpy, arrays),
                                          **kw)
        got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.dtype == np.int32 and (got >= 1).sum() > 0.5 * arrays[2].sum()
    final = port_scan.state_to_numpy(state)
    for name, value in jax_state._asdict().items():
        assert final[name].dtype == np.asarray(value).dtype, name
        assert scaled_err(final[name], np.asarray(value)) <= 1e-4, name
    if case == "overflow":
        assert final["active"].all()


def test_assign_track_ids_matches_jax():
    seq = walkers(12, 4, seed=2, gaps=True)
    got = frame_results(port_dto, seq)
    got[3].timestamp = None  # a frame without a timestamp advances by 1 s
    got[5].timestamp = seq[5][0].isoformat()
    want = frame_results(jax_dto, seq)
    want[3].timestamp, want[5].timestamp = None, seq[5][0].isoformat()
    ids = port_scan.assign_track_ids(got, capacity=8, device="cpu", min_hits=2)
    np.testing.assert_array_equal(ids, jax_scan.assign_track_ids(want, capacity=8, min_hits=2))
    assert ids_of(got) == ids_of(want)
    np.testing.assert_array_equal(port_scan.pack_frame_results(got)[4],
                                  [1, 10, 10, 1, 309, 10, 10, 10, 10, 10, 300, 10])


# --------------------------------------------------------------------- ReID
def test_reid_histogram_and_clip_cases(caplog):
    rng = np.random.default_rng(4)
    frame = rng.integers(0, 255, (120, 160, 3), np.uint8)
    boxes = [(10.0, 20.0, 40.0, 60.0), (100.0, 30.0, 30.0, 50.0)]
    for cfg in ({"tracking.reid.model_type": "histogram"}, {"tracking.reid.model_type": "detr"},
                {"tracking.reid.model_type": "clip"}):
        port, ref = port_reid.ReIDFeatureExtractor.from_config(cfg), jax_reid.ReIDFeatureExtractor.from_config(cfg)
        with caplog.at_level(logging.WARNING):
            port.load_model()
            ref.load_model()
        assert (port.backend, port.feature_dim) == (ref.backend, ref.feature_dim) == ("histogram", 256)
        np.testing.assert_array_equal(port.extract_features(frame, boxes), ref.extract_features(frame, boxes))
        assert port.extract_features(frame, []).shape == (0, 256)
    assert sum("CLIP unavailable" in r.getMessage() for r in caplog.records) == 2  # one a package
    for key in ("model_name", "model_path"):
        clip = port_reid.ReIDFeatureExtractor.from_config({"tracking.reid.model_type": "clip",
                                                           f"tracking.reid.{key}": "openai/clip-vit-base-patch32"})
        with pytest.raises(NotImplementedError, match="ROADMAP A.3b"):
            clip.load_model()


# ------------------------------------------------------- exports and phase
def read_outputs(out) -> dict:
    return {p.name: p.read_bytes() for p in sorted(out.iterdir()) if p.is_file()}


def test_trajectory_exporter_matches_jax(tmp_path):
    seq = walkers(6, 3, seed=8)
    files = {}
    for name, cls in (("port", TrajectoryExporter), ("jax", JaxTrajectoryExporter)):
        results = frame_results(PACKAGES[name], seq)
        for i, fr in enumerate(results):
            for j, d in enumerate(fr.detections):
                d.track_id = None if j == 0 else j + i % 2
                d.floor_coords_mm = (1000.0 + 7.25 * i, 2000.0 / (j + 1)) if j % 2 else None
        results[2].detections = []
        ex = cls(tmp_path / name)
        made = [ex.export_csv(results), ex.export_mot_csv(results), ex.export_json(results),
                ex.export_frame_index(results)]
        files[name] = read_outputs(tmp_path / name)
        assert [p.name for p in made] == ["tracks.csv", "tracks_mot.csv", "tracks.json", "frames_index.csv"]
    assert files["port"] == files["jax"]


PHASE_CASES = {
    "cascade": {},
    "scan": {"tracking.engine": "scan", "tracking.min_hits": 2},
    "hybrid": {"tracking.hybrid_mode.enabled": True, "tracking.engine": "scan", "output.save_tracking_images": True},
}


@pytest.mark.parametrize("case", list(PHASE_CASES))
def test_tracking_phase_matches_jax(tmp_path, case, caplog):
    seq = walkers(14, 5, seed=6, blank=(6,))
    frames = render(seq)
    cfg = {"detection.device": "cpu", "tracking.max_age": 5, **PHASE_CASES[case]}
    outputs = {}
    for name, cls in (("port", TrackingPhase), ("jax", JaxTrackingPhase)):
        results = frame_results(PACKAGES[name], seq)
        with caplog.at_level(logging.WARNING):
            phase = cls(cfg)
            phase.execute(results, frames, tmp_path / name)
        outputs[name] = (ids_of(results), phase.statistics, read_outputs(tmp_path / name))
        phase.cleanup()
    assert outputs["port"][0] == outputs["jax"][0]
    assert outputs["port"][1] == outputs["jax"][1] and outputs["port"][1]["unique_tracks"] >= 5
    assert outputs["port"][2] == outputs["jax"][2]
    assert {"tracks.csv", "tracks_mot.csv", "tracks.json", "frames_index.csv",
            "tracking_statistics.json"} <= set(outputs["port"][2])
    if case == "hybrid":  # the blank frame gets the tracks' interpolated boxes
        assert outputs["port"][0][6] and sum(n.startswith("tracked_") for n in outputs["port"][2]) == len(seq)
        assert sum("tracking.engine=scan is ignored" in r.getMessage() for r in caplog.records) == 2


def test_dense_tracking_windows_and_dedup_match_jax(tmp_path):
    """A 10 s dense grid tracked, then cut into 1-minute windows with one
    detection per track id; Phase 4 counts each person once a window."""
    seq = walkers(20, 3, seed=9, fp=0, drop=0.0, blank=(13,))
    cfg = {"detection.device": "cpu", "video.dense_tracking.output_interval_minutes": 1,
           "zones": [{"id": "left", "polygon": [[0, 0], [300, 0], [300, 400], [0, 400]]},
                     {"id": "right", "polygon": [[300, 0], [700, 0], [700, 400], [300, 400]]}]}
    counts = {}
    for name, track_cls, agg_cls in (("port", TrackingPhase, AggregationPhase),
                                     ("jax", JaxTrackingPhase, JaxAggregationPhase)):
        results = frame_results(PACKAGES[name], seq)
        phase = track_cls(cfg)
        phase.execute(results)
        windows = phase.aggregate_to_output_intervals(results)
        for fr in windows:
            for d in fr.detections:
                d.zone_ids = ["left" if d.center[0] < 300 else "right"]
        agg_cls(cfg).execute(windows, tmp_path / name)
        counts[name] = ((tmp_path / name / "zone_counts.csv").read_text(),
                        [(fr.frame_number, fr.timestamp_str, sorted(d.track_id for d in fr.detections))
                         for fr in windows])
    assert counts["port"] == counts["jax"]
    rows = counts["port"][1]
    assert len(rows) == 4 and [r[0] for r in rows] == [0, 5, 11, 17]  # windows 09:00-09:03, first frame each
    assert all(len(ids) == len(set(ids)) <= 3 for _, _, ids in rows)  # one detection per id a window
    assert sum(len(ids) for _, _, ids in rows) < sum(len(d) for _, d in seq)


# --------------------------------------------------------------- MOT metrics
def mot_case(seed: int) -> tuple[dict, dict]:
    """Ground truth of 4 walkers over 30 frames, and a hypothesis with
    noise, misses, false positives and two id swaps."""
    rng = np.random.default_rng(seed)
    gt, hyp = {}, {}
    for f in range(1, 31):
        gt[f] = [(p + 1, (40.0 * p + 6.0 * f, 100.0 + 25 * p, 40.0, 90.0)) for p in range(4)]
        hyp[f] = []
        for p, (_, (x, y, w, h)) in enumerate(gt[f]):
            if rng.random() < 0.1:
                continue
            tid = 10 + p if f < 12 else (10 + (p + 1) % 4 if f < 20 else 20 + p)
            hyp[f].append((tid, (x + rng.normal(0, 4), y + rng.normal(0, 4), w, h)))
        if rng.random() < 0.3:
            hyp[f].append((99, tuple(float(v) for v in rng.uniform([0, 0, 30, 60], [400, 300, 50, 100]))))
    hyp[31] = [(50, (0.0, 0.0, 10.0, 10.0))]  # a frame with no ground truth
    return gt, hyp


@pytest.mark.parametrize("seed", [0, 1])
def test_mot_metrics_match_jax(seed, tmp_path):
    gt, hyp = mot_case(seed)
    events = [{}, {}]
    got = port_mot.evaluate_mot(gt, hyp, events[0]).to_dict()
    want = jax_mot.evaluate_mot(gt, hyp, events[1]).to_dict()
    assert got == want and events[0] == events[1] and want["id_switches"] > 0
    assert port_mot.evaluate_hota(gt, hyp).to_dict() == jax_mot.evaluate_hota(gt, hyp).to_dict()
    assert port_mot.evaluate_mot({}, {}).to_dict() == jax_mot.evaluate_mot({}, {}).to_dict()

    mot_csv = tmp_path / "tracks_mot.csv"
    mot_csv.write_text("frame,id,x,y,w,h\n" + "".join(
        f"{f},{tid},{b[0]:.2f},{b[1]:.2f},{b[2]:.2f},{b[3]:.2f},0.9,-1,-1,-1\n" for f, rows in hyp.items()
        for tid, b in rows) + "3,7,500,300,0,0,1,-1,-1,-1\n")
    assert port_mot.load_mot_csv(mot_csv) == jax_mot.load_mot_csv(mot_csv)
    gold = tmp_path / "gold.json"
    gold.write_text('{"frames": [{"frame_idx": 0, "annotations": [{"person_id": 1, "bbox": [1, 2, 3, 4]}]},'
                    ' {"frame_number": 5, "tracks": [{"track_id": 2, "bbox": {"x": 1, "y": 2, "width": 3,'
                    ' "height": 4}}]}]}')
    assert port_mot.load_gold_gt(gold) == jax_mot.load_gold_gt(gold) == {1: [(1, (1.0, 2.0, 3.0, 4.0))],
                                                                           5: [(2, (1, 2, 3, 4))]}
