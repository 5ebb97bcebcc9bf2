"""The slice as a whole: the port's Phases 2-4 against the JAX package's, on
the CPU in float32.

- Detection: the committed DETR-small checkpoint at 224x384 through both
  packages' ``DetectionPhase`` on rendered frames (a batch of 2 and a tail
  of 1): the same valid detections, boxes within the repo's DETR bar (1e-3
  of the normalised box); ``detections.json`` and
  ``detection_statistics.json`` with the same keys and values: pixel fields
  within that bar (1.3 px), confidences and their statistics within 1e-3,
  counts exactly.
- ``utils/stats_utils.py`` (``calculate_detection_statistics``,
  ``calculate_frame_statistics``) on the same batches within 1e-6, and
  ``utils/image_utils.py`` (``save_detection_image``): the same image bytes.
- Transform and aggregation: the same seeded detections through both
  packages' ``TransformPhase`` and ``AggregationPhase``, with a homography
  and with piecewise-affine plus lens undistortion (and thin-plate spline,
  compact JSON): ``coordinate_transformations.json`` within 1e-3 px,
  ``zone_counts.csv`` byte-identical.
- The phase-level refusals: non-DETR detectors; attention-map overlays,
  which the phase now takes.
"""

import json
from datetime import datetime, timedelta

import jax.numpy as jnp
import numpy as np
import pytest

from office_person_detection_vit_torch.core import dto as port_dto
from office_person_detection_vit_torch.pipeline.phases import AggregationPhase, DetectionPhase, TransformPhase
from office_person_detection_vit_torch.utils import stats_utils as port_stats
from office_person_detection_vit_tpu.config.config_manager import ConfigManager
from office_person_detection_vit_tpu.core import dto as jax_dto
from office_person_detection_vit_tpu.pipeline.phases.aggregation import AggregationPhase as JaxAggregationPhase
from office_person_detection_vit_tpu.pipeline.phases.detection import DetectionPhase as JaxDetectionPhase
from office_person_detection_vit_tpu.pipeline.phases.transform import TransformPhase as JaxTransformPhase
from office_person_detection_vit_tpu.utils import stats_utils as jax_stats
from tests.helpers.synthetic_video import render_frame
from tests.test_torch_features import SMALL
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

PX_TOL = 1e-3
T0 = datetime(2025, 1, 20, 9, 0, 0)
#: A camera -> floormap homography that puts a 1280x720 frame on the
#: 1878x1369 floormap, with a little perspective.
H = np.array([[1.2, 0.1, 50.0], [0.05, 1.5, 60.0], [1e-5, 2e-4, 1.0]])
ZONES = [
    {"id": "zone_1", "name": "desks", "polygon": [[100, 100], [900, 100], [900, 700], [100, 700]], "priority": 2},
    {"id": "zone_2", "name": "meeting", "polygon": [[700, 500], [1500, 450], [1600, 1100], [650, 1000]],
     "priority": 1},
    {"id": "zone_3", "name": "kitchen", "polygon": [[1000, 100], [1700, 120], [1400, 400]], "priority": 3},
]
LENS = {"enabled": True, "k1": -0.12, "k2": 0.03, "p1": 1.5e-3, "p2": -8e-4}


def _config(tmp_path, **sections):
    cfg = {"detection": {"device": "cpu"}, "parallel": {"mesh": {"data": 1}}, "homography": {"matrix": H.tolist()},
           "zones": ZONES}
    cfg.update(sections)
    return ConfigManager.from_dict(cfg)


# ------------------------------------------------------------------ detection
@pytest.fixture(scope="module")
def detection_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("detect")
    people = [[(500, 350, 2)], [(150, 200, 0), (900, 150, 1)], [(1000, 450, 3)]]
    frames = [render_frame(T0 + timedelta(minutes=5 * i), people=p, seed=4 + i) for i, p in enumerate(people)]
    cfg = _config(tmp, detection=SMALL | {"batch_size": 2})
    runs = {}
    for name, phase_cls, dto in (("jax", JaxDetectionPhase, jax_dto), ("port", DetectionPhase, port_dto)):
        results = [dto.FrameResult(i, T0 + timedelta(minutes=5 * i)) for i in range(len(frames))]
        phase = phase_cls(cfg)
        phase.execute(frames, results, tmp / name)
        runs[name] = (phase, results, tmp / name)
    return runs


def test_detection_phase_matches_jax(detection_runs):
    (jphase, jres, _), (pphase, pres, _) = detection_runs["jax"], detection_runs["port"]
    wh = np.asarray([1280, 720, 1280, 720], np.float32)
    np.testing.assert_array_equal(pphase.last_batch.valid, np.asarray(jphase.last_batch.valid))
    np.testing.assert_allclose(pphase.last_batch.boxes_xywh / wh, np.asarray(jphase.last_batch.boxes_xywh) / wh,
                               rtol=0, atol=1e-3)
    assert sum(len(r.detections) for r in pres) >= 3
    for w, g in zip(jres, pres):
        assert (g.frame_number, g.timestamp_str, g.timestamp_stem) == (w.frame_number, w.timestamp_str, w.timestamp_stem)
        assert len(g.detections) == len(w.detections)


def _assert_json_close(got, want, tol, path="$", key_tols=None):
    """Equal structure and keys; numbers within tol (within key_tols[k]
    under a key k); everything else, counts included, equal."""
    key_tols = key_tols or {}
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_json_close(got[k], want[k], key_tols.get(k, tol), f"{path}.{k}", key_tols)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_json_close(g, w, tol, f"{path}[{i}]", key_tols)
    elif isinstance(want, float) or isinstance(got, float):
        assert got == pytest.approx(want, abs=tol), path
    else:
        assert got == want, path


#: Pixel fields of detections.json: the DETR bar of the normalised box,
#: 1e-3 x 1280 px. Every other number (confidences and their statistics)
#: within 1e-3; counts exactly.
DETECTION_PX_TOL = 1.3
DETECTION_PX_KEYS = {"bbox": DETECTION_PX_TOL, "camera_coords": DETECTION_PX_TOL}


def test_detection_artifacts_match_jax(detection_runs):
    jdir, pdir = detection_runs["jax"][2], detection_runs["port"][2]
    for name in ("detections.json", "detection_statistics.json"):
        got, want = (json.loads((d / name).read_text()) for d in (pdir, jdir))
        _assert_json_close(got, want, 1e-3, name, DETECTION_PX_KEYS)
        if name == "detection_statistics.json":
            # the same valid sets, so the same per-frame counts
            assert got["avg_detections_per_frame"] == want["avg_detections_per_frame"]


def test_detection_json_tolerances_are_per_field():
    """A confidence or a statistic 0.5 off fails, where a pixel 1 px off passes."""
    want = {"frames": [{"detections": [{"bbox": {"x": 10.0}, "confidence": 0.5}]}],
            "confidence": {"std": 0.1}}
    _assert_json_close({"frames": [{"detections": [{"bbox": {"x": 11.0}, "confidence": 0.5}]}],
                        "confidence": {"std": 0.1}}, want, 1e-3, "$", DETECTION_PX_KEYS)
    for bad in ({"frames": [{"detections": [{"bbox": {"x": 10.0}, "confidence": 1.0}]}], "confidence": {"std": 0.1}},
                {"frames": [{"detections": [{"bbox": {"x": 10.0}, "confidence": 0.5}]}], "confidence": {"std": 0.6}}):
        with pytest.raises(AssertionError):
            _assert_json_close(bad, want, 1e-3, "$", DETECTION_PX_KEYS)


# --------------------------------------------------- statistics and images
def _stats_batches(dto, xp):
    """A seeded batch with empty frames, one with nothing valid, one empty."""
    rng = np.random.default_rng(21)
    valid = rng.random((6, 10)) < 0.4
    valid[2] = False
    cases = [(rng.uniform(0, 700, (6, 10, 4)), rng.uniform(0.2, 1.0, (6, 10)), valid),
             (np.zeros((3, 4, 4)), np.full((3, 4), 0.7), np.zeros((3, 4), bool)),
             (np.zeros((0, 1, 4)), np.zeros((0, 1)), np.zeros((0, 1), bool))]
    return [dto.DetectionBatch(boxes_xywh=xp.asarray(b, np.float32), scores=xp.asarray(sc, np.float32),
                               valid=xp.asarray(v), foot=xp.asarray(b[..., :2], np.float32)) for b, sc, v in cases]


@pytest.mark.parametrize("case", [0, 1, 2], ids=["seeded", "none_valid", "no_frames"])
def test_detection_statistics_match_jax(case):
    got = port_stats.calculate_detection_statistics(_stats_batches(port_dto, np)[case])
    want = jax_stats.calculate_detection_statistics(_stats_batches(jax_dto, jnp)[case])
    _assert_json_close(got, want, 1e-6)
    if case == 0:
        assert got["total_detections"] > 0 and got["min_detections_per_frame"] == 0


def _frame_lists(dto):
    rng = np.random.default_rng(22)
    frames = []
    for f in range(5):
        n = 0 if f == 1 else int(rng.integers(1, 9))
        dets = [dto.Detection(bbox=tuple(float(v) for v in b), confidence=float(c))
                for b, c in zip(rng.uniform([0, 0, 20, 40], [1200, 600, 80, 200], (n, 4)), rng.uniform(0.1, 1, n))]
        frames.append(dto.FrameResult(f, T0 + timedelta(minutes=5 * f), dets))
    return frames


@pytest.mark.parametrize("n_frames", [5, 1, 0])
def test_frame_statistics_match_jax(n_frames):
    got = port_stats.calculate_frame_statistics(_frame_lists(port_dto)[:n_frames])
    want = jax_stats.calculate_frame_statistics(_frame_lists(jax_dto)[:n_frames])
    _assert_json_close(got, want, 1e-6)


@pytest.mark.parametrize("kwargs", [{}, {"draw_confidence": False, "draw_foot_point": False},
                                    {"draw_track_ids": True}], ids=["default", "boxes_only", "track_ids"])
def test_save_detection_image_matches_jax(tmp_path, kwargs):
    pytest.importorskip("cv2")
    from office_person_detection_vit_torch.utils.image_utils import save_detection_image
    from office_person_detection_vit_tpu.utils.image_utils import save_detection_image as jax_save_detection_image

    frame = render_frame(T0, people=[(300, 200, 1), (330, 230, 2), (900, 400, 3)], seed=9)
    out = {}
    for name, dto, save in (("jax", jax_dto, jax_save_detection_image), ("port", port_dto, save_detection_image)):
        # two overlapping labels (the second is moved down), one tracked
        dets = [dto.Detection(bbox=(300.0, 174.0, 50.0, 156.0), confidence=0.91, track_id=3),
                dto.Detection(bbox=(330.4, 204.0, 50.0, 156.0), confidence=0.5),
                dto.Detection(bbox=(900.0, 374.6, 50.2, 156.0), confidence=0.77, track_id=12)]
        path = save(frame, dets, tmp_path / name / "detection.png", **kwargs)
        assert path == tmp_path / name / "detection.png"
        out[name] = path.read_bytes()
    assert out["port"] == out["jax"]


# ----------------------------------------------------------- transform + zones
def _seeded_frames(dto):
    """8 frames (one empty, one without a timestamp) of up to 12 seeded
    detections whose foot points lie in the camera frame."""
    rng = np.random.default_rng(11)
    frames = []
    for f in range(8):
        n = 0 if f == 3 else int(rng.integers(4, 13))
        feet = rng.uniform([30, 60], [1250, 700], (n, 2))
        wh = rng.uniform([30, 80], [70, 200], (n, 2))
        dets = [dto.Detection(bbox=(float(x - w / 2), float(y - h), float(w), float(h)), confidence=float(c))
                for (x, y), (w, h), c in zip(feet, wh, rng.uniform(0.3, 1.0, n))]
        frames.append(dto.FrameResult(f, None if f == 5 else T0 + timedelta(minutes=5 * f), dets))
    return frames


@pytest.fixture(scope="module")
def correspondence_file(tmp_path_factory):
    rng = np.random.default_rng(12)
    src = rng.uniform([0, 0], [1280, 720], (40, 2))
    hom = np.c_[src, np.ones(len(src))] @ H.T
    dst = hom[:, :2] / hom[:, 2:] + 10 * np.sin(src / 250.0)
    path = tmp_path_factory.mktemp("corr") / "correspondences.json"
    path.write_text(json.dumps({"points": [{"camera": s, "floormap": d} for s, d in zip(src.tolist(), dst.tolist())]}))
    return path


@pytest.mark.parametrize(
    "method,lens,overlap,json_opt",
    [
        ("homography", False, "all", {}),
        ("piecewise_affine", True, "all", {"enabled": True, "coordinate_precision": 3}),
        ("piecewise_affine", True, "priority", {"enabled": True, "compact_keys": True, "exclude_px_coords": True,
                                                "coordinate_precision": 2}),
        ("thin_plate_spline", False, "priority", {}),
    ],
    ids=["homography", "pwa_undistorted", "pwa_undistorted_priority_compact", "tps_priority"],
)
def test_transform_and_aggregation_phases_match_jax(tmp_path, correspondence_file, method, lens, overlap, json_opt):
    transform = {"method": method, "lens_distortion": LENS if lens else {"enabled": False}}
    cfg = _config(tmp_path, transform=transform, calibration={"correspondence_file": str(correspondence_file)},
                  zones_overlap_mode=overlap, output={"json_optimization": json_opt})
    outputs = {}
    for name, dto, tphase, aphase in (("jax", jax_dto, JaxTransformPhase, JaxAggregationPhase),
                                      ("port", port_dto, TransformPhase, AggregationPhase)):
        frames = _seeded_frames(dto)
        tp = tphase(cfg)
        tp.execute(frames, tmp_path / name)
        results = aphase(cfg).execute(frames, tmp_path / name)
        outputs[name] = (frames, results, tp)
    (jframes, jresults, jtp), (pframes, presults, ptp) = outputs["jax"], outputs["port"]
    assert (ptp.undistorter is not None) == lens and ptp.statistics == jtp.statistics
    assert ptp.statistics["zone_classified"] > 0 and ptp.statistics["unclassified"] > 0
    for fj, fp in zip(jframes, pframes):
        assert fp.zone_counts == fj.zone_counts
        for dj, dp in zip(fj.detections, fp.detections):
            assert dp.zone_ids == dj.zone_ids
            np.testing.assert_allclose(dp.floor_coords_px, dj.floor_coords_px, rtol=0, atol=PX_TOL)
    assert [r.__dict__ for r in presults] == [r.__dict__ for r in jresults]
    if overlap == "all":
        assert any(len(d.zone_ids) > 1 for f in pframes for d in f.detections)  # the overlap is exercised

    got, want = (json.loads((tmp_path / n / "coordinate_transformations.json").read_text()) for n in ("port", "jax"))
    # Millimetres are pixels times 28.2: within 1e-3 px of the floormap.
    _assert_json_close(got, want, 28.3 * PX_TOL, "coordinate_transformations.json")
    assert (tmp_path / "port" / "zone_counts.csv").read_bytes() == (tmp_path / "jax" / "zone_counts.csv").read_bytes()


def test_empty_run_writes_the_same_artifacts(tmp_path):
    cfg = _config(tmp_path)
    for name, dto, tphase, aphase in (("jax", jax_dto, JaxTransformPhase, JaxAggregationPhase),
                                      ("port", port_dto, TransformPhase, AggregationPhase)):
        frames = [dto.FrameResult(0, T0)]
        tphase(cfg).execute(frames, tmp_path / name)
        aphase(cfg).execute(frames, tmp_path / name)
    for art in ("coordinate_transformations.json", "zone_counts.csv"):
        assert (tmp_path / "port" / art).read_bytes() == (tmp_path / "jax" / art).read_bytes()


# -------------------------------------------------------------------- refusals
@pytest.fixture(scope="module")
def single_shot_weights(tmp_path_factory):
    """The JAX tiny single-shot and YOLOv8 inits as the trainer's flat npz."""
    import jax

    from office_person_detection_vit_tpu.models.single_shot import SingleShotConfig, init_single_shot
    from office_person_detection_vit_tpu.models.yolo import YOLOConfig, init_yolo

    tmp = tmp_path_factory.mktemp("ss")
    paths = {}
    for name, init, cfg in (("ssd", init_single_shot, SingleShotConfig.tiny()), ("yolo", init_yolo, YOLOConfig.tiny())):
        _, variables = init(cfg, jax.random.PRNGKey(2), input_hw=(64, 64))
        paths[name] = tmp / f"{name}.npz"
        np.savez(paths[name], **{f"leaf_{i}": np.asarray(a)
                                 for i, a in enumerate(jax.tree_util.tree_leaves(jax.device_get(variables)))})
    return paths


@pytest.mark.parametrize("model", ["ssd", "fcos", "yolo"])
def test_detection_phase_runs_the_single_shot_detectors(tmp_path, single_shot_weights, model):
    """``detection.model`` ssd / fcos (the single-shot detector) and yolo
    (YOLOv8) build the port's detectors, which detect through the phase and
    write the JAX phase's artifacts on the same weights (no transfer_format:
    neither JAX facade has one)."""
    family = "yolo" if model == "yolo" else "ssd"
    detection = {"device": "cpu", "model": model, "model_size": "tiny", "batch_size": 2, "input_height": 96,
                 "input_width": 128, "confidence_threshold": 0.0, "checkpoint_path": str(single_shot_weights[family])}
    cfg = _config(tmp_path, detection=detection)
    frames = [render_frame(T0 + timedelta(minutes=5 * i), people=[(300 + 200 * i, 300, i)], seed=i)[::6, ::8].copy()
              for i in range(3)]
    for name, phase_cls, dto in (("jax", JaxDetectionPhase, jax_dto), ("port", DetectionPhase, port_dto)):
        results = [dto.FrameResult(i, T0 + timedelta(minutes=5 * i)) for i in range(len(frames))]
        phase_cls(cfg).execute(frames, results, tmp_path / name)
    phase = DetectionPhase(cfg)
    phase.initialize()
    assert type(phase.detector).__name__ == ("YOLODetector" if model == "yolo" else "SSDDetector")
    for name in ("detections.json", "detection_statistics.json"):
        got, want = (json.loads((tmp_path / d / name).read_text()) for d in ("port", "jax"))
        _assert_json_close(got, want, 1e-3, name, DETECTION_PX_KEYS)
    stats = json.loads((tmp_path / "port" / "detection_statistics.json").read_text())
    assert stats["total_detections"] > 0 and "transfer_format" not in stats


def test_detection_phase_refuses_attention_overlays(tmp_path):
    """Refused until the overlays were ported (ROADMAP A.3b); the phase now
    takes the key as the JAX phase does (the overlays themselves are held
    to JAX's in ``tests/test_torch_host_leftovers.py``)."""
    cfg = _config(tmp_path, output={"save_attention_maps": True})
    assert DetectionPhase(cfg).save_attention and JaxDetectionPhase(cfg).save_attention
    assert not DetectionPhase(_config(tmp_path)).save_attention
