"""The port's last host modules against the JAX package's, on the CPU.

The same numpy-seeded inputs go through both:

- ``detection/preprocessing.py``: every step and ``apply_pipeline``,
  byte-equal images;
- ``core/policy.py``'s ``OutputPolicy``: equal; ``core/interfaces.py``: the
  port's detector, tracker, transformers and aggregator satisfy the port's
  Protocols as the JAX ones satisfy theirs;
- ``calibration/reprojection_error.py`` and
  ``evaluation/transform_evaluator.py`` over homography, piecewise-affine
  and thin-plate-spline transformers: every statistic within 1e-4 px plus
  one float32 step of the largest floor coordinate (1.2e-4 px between 1024
  and 2048 px: each package's transformer rounds its float32 output in its
  own summation order, and a TPS refit on a duplicated point carries one
  such step into its fold), the leave-one-out folds (degenerate ones
  included) too; the error plot at the JAX figure's size;
- ``python -m ...benchmark`` (``benchmark.main``): the same JSON printed,
  dense and ``--sparse``, the same text lines, and ``--report``'s json, md
  and diagnostics files equal;
- ``visualization/dashboard_utils.py``: every reader equal on one
  hand-written session directory, the live projection of tracks included;
- ``utils/export_utils.py``: ``pair_images`` and ``crop_and_zoom_floormap``
  equal, the side-by-side MP4 with the same frame count and size (also
  through ``VisualizationPhase``), the tracked image sequence byte-equal;
- the attention-map overlays of ``DetectionPhase`` with the committed
  DETR-small checkpoint on 2 frames: the same ``attention_*.jpg`` names,
  the overlays drawn within 2 grey levels (maps within 1e-7 can move a
  pixel one step of the colour map), their JPEG files within 4 (the
  encoder's blocks spread such a step);
- ``visualization/feature_visualizer.py`` on seeded separated blobs: the
  silhouette within 1e-6 of sklearn's for the same labels; KMeans labels
  equal up to a permutation, inertia within 1e-4 relative; t-SNE's exact
  KL divergence at most 1.05x that of JAX's (sklearn's) embedding plus
  0.05, both under the port's P, and the t-SNE silhouette by true ids at
  least 0.5.
"""

import json
from datetime import datetime, timedelta
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from office_person_detection_vit_torch import benchmark as port_bench
from office_person_detection_vit_torch.aggregation.aggregator import Aggregator
from office_person_detection_vit_torch.calibration.reprojection_error import ReprojectionErrorEvaluator
from office_person_detection_vit_torch.core import dto as port_dto
from office_person_detection_vit_torch.core import interfaces as port_ifaces
from office_person_detection_vit_torch.core.policy import OutputPolicy
from office_person_detection_vit_torch.detection import preprocessing as port_pre
from office_person_detection_vit_torch.detection.detector import DETRDetector
from office_person_detection_vit_torch.evaluation import TransformEvaluator
from office_person_detection_vit_torch.pipeline.phases import DetectionPhase, VisualizationPhase
from office_person_detection_vit_torch.tracking.tracker import Tracker
from office_person_detection_vit_torch.transform.homography import HomographyTransformer
from office_person_detection_vit_torch.transform.piecewise_affine import (PiecewiseAffineTransformer,
                                                                          ThinPlateSplineTransformer)
from office_person_detection_vit_torch.utils.export_utils import SideBySideVideoExporter, TrajectoryExporter
from office_person_detection_vit_torch.visualization import FeatureVisualizer, SessionDataLoader
from office_person_detection_vit_torch.visualization import dashboard_utils as port_dash
from office_person_detection_vit_torch.visualization import feature_visualizer as port_fv
from office_person_detection_vit_tpu import benchmark as jax_bench
from office_person_detection_vit_tpu.aggregation.aggregator import Aggregator as JaxAggregator
from office_person_detection_vit_tpu.calibration.reprojection_error import (
    ReprojectionErrorEvaluator as JaxReprojectionErrorEvaluator)
from office_person_detection_vit_tpu.config.config_manager import ConfigManager
from office_person_detection_vit_tpu.core import dto as jax_dto
from office_person_detection_vit_tpu.core import interfaces as jax_ifaces
from office_person_detection_vit_tpu.core.policy import OutputPolicy as JaxOutputPolicy
from office_person_detection_vit_tpu.detection import preprocessing as jax_pre
from office_person_detection_vit_tpu.detection.detector import DETRDetector as JaxDETRDetector
from office_person_detection_vit_tpu.evaluation import TransformEvaluator as JaxTransformEvaluator
from office_person_detection_vit_tpu.pipeline.phases.detection import DetectionPhase as JaxDetectionPhase
from office_person_detection_vit_tpu.pipeline.phases.visualization import VisualizationPhase as JaxVisualizationPhase
from office_person_detection_vit_tpu.tracking.tracker import Tracker as JaxTracker
from office_person_detection_vit_tpu.transform.homography import HomographyTransformer as JaxHomographyTransformer
from office_person_detection_vit_tpu.transform.piecewise_affine import (
    PiecewiseAffineTransformer as JaxPiecewiseAffineTransformer,
    ThinPlateSplineTransformer as JaxThinPlateSplineTransformer)
from office_person_detection_vit_tpu.utils.export_utils import SideBySideVideoExporter as JaxSideBySideVideoExporter
from office_person_detection_vit_tpu.utils.export_utils import TrajectoryExporter as JaxTrajectoryExporter
from office_person_detection_vit_tpu.visualization import FeatureVisualizer as JaxFeatureVisualizer
from office_person_detection_vit_tpu.visualization import SessionDataLoader as JaxSessionDataLoader
from office_person_detection_vit_tpu.visualization import dashboard_utils as jax_dash
from tests.helpers.synthetic_video import render_frame
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)
from tests.test_torch_features import SMALL

T0 = datetime(2025, 1, 20, 9, 0, 0)
PX_TOL = 1e-4
H = np.array([[1.2, 0.1, 50.0], [0.05, 1.5, 60.0], [1e-5, 2e-4, 1.0]])


# ------------------------------------------------------------ preprocessing
def _ocr_image() -> np.ndarray:
    """A bright band with dark digits, rotated 4 degrees, with noise."""
    img = np.full((90, 320, 3), 235, np.uint8)
    cv2.putText(img, "2025-01-20 09:05:00", (8, 58), cv2.FONT_HERSHEY_SIMPLEX, 0.9, (20, 20, 20), 2)
    m = cv2.getRotationMatrix2D((160, 45), 4.0, 1.0)
    img = cv2.warpAffine(img, m, (320, 90), borderValue=(235, 235, 235))
    noise = np.random.default_rng(3).integers(-12, 13, img.shape)
    return np.clip(img.astype(np.int32) + noise, 0, 255).astype(np.uint8)


PIPELINES = {
    "clahe_color": [{"name": "clahe", "clip_limit": 3.0, "tile_grid_size": 4}],
    "ocr": [{"name": "grayscale"}, {"name": "resize", "scale": 1.5}, {"name": "unsharp_mask", "amount": 0.7},
            {"name": "threshold"}, {"name": "morphology", "operation": "close"}, {"name": "invert"}],
    "adaptive": [{"name": "grayscale"}, {"name": "blur", "kernel_size": 4}, {"name": "threshold", "adaptive": True},
                 {"name": "morphology", "operation": "dilate", "iterations": 2}],
    "deskew": [{"name": "deskew"}, {"name": "resize", "width": 200}, {"name": "blur", "gaussian": False}],
    "fixed": [{"name": "resize", "height": 60}, {"name": "threshold", "value": 128},
              {"name": "morphology", "operation": "tophat"}, {"name": "morphology", "operation": "nope"}],
}


@pytest.mark.parametrize("case", list(PIPELINES))
def test_preprocessing_is_byte_equal_to_jax(case):
    img = _ocr_image()
    got, want = port_pre.apply_pipeline(img, PIPELINES[case]), jax_pre.apply_pipeline(img, PIPELINES[case])
    assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)
    for name in ("grayscale", "invert", "deskew"):
        assert np.array_equal(port_pre.PIPELINE_OPS[name](img), jax_pre.PIPELINE_OPS[name](img))
    assert set(port_pre.PIPELINE_OPS) == set(jax_pre.PIPELINE_OPS)
    with pytest.raises(ValueError, match="unknown preprocessing step"):
        port_pre.apply_pipeline(img, [{"name": "sharpen"}])


# ------------------------------------------------------------ core
def test_output_policy_and_protocols_match_jax():
    cfg = ConfigManager.from_dict({"output": {"save_detection_images": True, "save_side_by_side_video": True,
                                              "cleanup_temp_files": False}})
    assert OutputPolicy.from_config(cfg).__dict__ == JaxOutputPolicy.from_config(cfg).__dict__
    assert OutputPolicy() == OutputPolicy.from_config(ConfigManager.from_dict({}))
    pairs = {"DetectorPort": (DETRDetector, JaxDETRDetector), "TrackerPort": (Tracker, JaxTracker),
             "TransformerPort": (HomographyTransformer, JaxHomographyTransformer),
             "AggregatorPort": (Aggregator, JaxAggregator)}
    for proto, (port_cls, jax_cls) in pairs.items():
        assert issubclass(jax_cls, getattr(jax_ifaces, proto)), proto
        assert issubclass(port_cls, getattr(port_ifaces, proto)), proto
    for t in (PiecewiseAffineTransformer, ThinPlateSplineTransformer):
        assert issubclass(t, port_ifaces.TransformerPort)
    assert {n for n in dir(port_ifaces) if n.endswith("Port")} == {n for n in dir(jax_ifaces) if n.endswith("Port")}


# ------------------------------------------------------------ transform evaluation
def _correspondences(n: int = 14, seed: int = 6):
    rng = np.random.default_rng(seed)
    cam = rng.uniform([40, 40], [1240, 680], (n, 2))
    q = np.c_[cam, np.ones(n)] @ H.T
    floor = q[:, :2] / q[:, 2:] + rng.normal(0, 2.0, (n, 2))  # not exactly a homography
    return cam.astype(np.float32), floor.astype(np.float32)


BUILDERS = {
    "homography": (lambda c, f: HomographyTransformer(H, device="cpu"), lambda c, f: JaxHomographyTransformer(H)),
    "pwa": (lambda c, f: PiecewiseAffineTransformer(c, f, device="cpu"), JaxPiecewiseAffineTransformer),
    "tps": (lambda c, f: ThinPlateSplineTransformer(c, f, reg=0.5, device="cpu"),
            lambda c, f: JaxThinPlateSplineTransformer(c, f, reg=0.5)),
}


def _assert_stats_close(got: dict, want: dict, floor: np.ndarray):
    tol = PX_TOL + float(np.spacing(np.abs(floor).max().astype(np.float32)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, list):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=tol, equal_nan=True)
        elif isinstance(w, float):
            assert got[k] == pytest.approx(w, abs=tol, nan_ok=True), k
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("method", list(BUILDERS))
def test_transform_evaluator_matches_jax(method, tmp_path):
    cam, floor = _correspondences()
    port_build, jax_build = BUILDERS[method]
    port_t, jax_t = port_build(cam, floor), jax_build(cam, floor)
    cfg = ConfigManager.from_dict({"calibration": {"reprojection_error_threshold": 2.0}})
    port_ev, jax_ev = TransformEvaluator.from_config(cfg), JaxTransformEvaluator.from_config(cfg)
    _assert_stats_close(port_ev.evaluate(port_t, cam, floor), jax_ev.evaluate(jax_t, cam, floor), floor)
    got_cmp = TransformEvaluator().compare({"a": port_t}, cam[:5], floor[:5])
    _assert_stats_close(got_cmp["a"], JaxTransformEvaluator().compare({"a": jax_t}, cam[:5], floor[:5])["a"], floor)
    _assert_stats_close(ReprojectionErrorEvaluator(port_t).evaluate(cam, floor),
                        JaxReprojectionErrorEvaluator(jax_t).evaluate(cam, floor), floor)
    if method != "homography":
        # Leave-one-out with the first point repeated three times: folds
        # whose refit sees a duplicate keep working or fail alike.
        cam_cv, floor_cv = np.r_[cam, cam[:1], cam[:1]], np.r_[floor, floor[:1], floor[:1]]
        got = TransformEvaluator().cross_validate(port_build, cam_cv, floor_cv)
        want = JaxTransformEvaluator().cross_validate(jax_build, cam_cv, floor_cv)
        _assert_stats_close(got, want, floor)
        assert got["num_folds"] == 16
    pred = port_t.transform_batch(cam)
    paths = (TransformEvaluator().plot_errors(cam, floor, pred, tmp_path / "p" / "errors.png"),
             JaxTransformEvaluator().plot_errors(cam, floor, pred, tmp_path / "j" / "errors.png"))
    assert paths[0].name == paths[1].name and cv2.imread(str(paths[0])).shape == cv2.imread(str(paths[1])).shape


def test_loo_counts_a_degenerate_fold_as_jax():
    """Four collinear points and a fifth off the line: the homography refit
    without the fifth is degenerate and raises in both builders."""
    cam = np.array([[0, 0], [10, 10], [20, 20], [30, 30], [40, 0]], np.float32)
    floor = cam * 2.0

    def build(module_cls, **kw):
        from office_person_detection_vit_torch.ops.homography_fit import fit_homography_dlt

        def fn(c, f):
            h = fit_homography_dlt(c, f, device="cpu").numpy()
            if not np.isfinite(h).all() or len(c) < 5:
                raise ValueError("degenerate refit")
            return module_cls(h.astype(np.float64), **kw)
        return fn

    got = TransformEvaluator().cross_validate(build(HomographyTransformer, device="cpu"), cam, floor)
    want = JaxTransformEvaluator().cross_validate(build(JaxHomographyTransformer), cam, floor)
    _assert_stats_close(got, want, floor)
    assert got["failed_folds"] == 5 and np.isnan(got["loo_rmse"])


def test_homography_errors_match_jax():
    cam, floor = _correspondences()
    got = ReprojectionErrorEvaluator.homography_errors(H, cam, floor, device="cpu")
    np.testing.assert_allclose(got, JaxReprojectionErrorEvaluator.homography_errors(H, cam, floor), rtol=0, atol=PX_TOL)


# ------------------------------------------------------------ tracking benchmark CLI
@pytest.fixture(scope="module")
def mot_files(tmp_path_factory):
    """A gold-GT JSON (video frame numbers) and a tracks_mot.csv (1-based
    sample indices) of 3 people over 12 frames, with an ID switch, a missed
    person and false positives."""
    tmp = tmp_path_factory.mktemp("mot")
    rng = np.random.default_rng(9)
    gt_frames, rows = [], []
    for f in range(12):
        anns = []
        for p in range(3):
            box = [float(100 + 150 * p + 5 * f), float(80 + 3 * f), 60.0, 150.0]
            anns.append({"track_id": p + 1, "bbox": box})
            if p == 2 and f in (4, 5):
                continue  # missed
            tid = p + 1 if not (p == 1 and f >= 7) else 9  # an id switch
            jitter = rng.normal(0, 2, 4)
            rows.append([f + 1, tid, *(f"{v:.2f}" for v in np.add(box, jitter)), "0.900", -1, -1, -1])
        if f % 5 == 0:
            rows.append([f + 1, 50 + f, "900.00", "500.00", "60.00", "150.00", "0.400", -1, -1, -1])
        gt_frames.append({"frame_number": 300 * f, "annotations": anns})
    (tmp / "gt.json").write_text(json.dumps({"frames": gt_frames}))
    (tmp / "tracks_mot.csv").write_text("\n".join(",".join(map(str, r)) for r in rows) + "\n")
    mot_gt = [f"{fr['frame_number'] // 300 + 1},{a['track_id']},{','.join(f'{v:.2f}' for v in a['bbox'])},1,-1,-1,-1"
              for fr in gt_frames for a in fr["annotations"]]
    (tmp / "gt_mot.csv").write_text("\n".join(mot_gt) + "\n")
    return tmp


@pytest.mark.parametrize("args", [["--sparse"], ["--gt-format", "mot"], ["--gt-format", "mot", "--sparse"]],
                         ids=["gold_sparse", "mot_dense", "mot_sparse"])
def test_tracking_benchmark_cli_matches_jax(mot_files, tmp_path, capsys, args):
    gt = mot_files / ("gt_mot.csv" if "mot" in args else "gt.json")
    printed = {}
    for name, mod in (("port", port_bench), ("jax", jax_bench)):
        argv = ["--gt", str(gt), "--pred", str(mot_files / "tracks_mot.csv"), *args]
        assert mod.main([*argv, "--json"]) == 0
        printed[name] = json.loads(capsys.readouterr().out)
        assert mod.main([*argv, "--report", str(tmp_path / name)]) == 0
        printed[name + "_text"] = capsys.readouterr().out
    assert printed["port"] == printed["jax"] and printed["port_text"] == printed["jax_text"]
    assert printed["port"]["num_frames"] == 12 and printed["port"]["id_switches"] >= 1
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert len(files) == 6
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def test_benchmark_module_entry_point(mot_files, monkeypatch, capsys):
    import runpy
    import sys

    monkeypatch.setattr(sys, "argv", ["benchmark", "--gt", str(mot_files / "gt_mot.csv"), "--gt-format", "mot",
                                      "--pred", str(mot_files / "tracks_mot.csv"), "--json"])
    with pytest.raises(SystemExit) as done:
        runpy.run_module("office_person_detection_vit_torch.benchmark", run_name="__main__")
    assert done.value.code == 0
    assert {"mota", "idf1", "hota"} <= set(json.loads(capsys.readouterr().out))


# ------------------------------------------------------------ dashboard loader
def _session(root: Path, with_transform: bool) -> Path:
    s = root / "20250120_090000"
    for d in ("01_extraction", "02_detection", "03_tracking", "04_transform", "05_aggregation", "06_visualization"):
        (s / d).mkdir(parents=True)
    (s / "metadata.json").write_text(json.dumps({"session": s.name, "video": "v.mp4"}))
    (s / "summary.json").write_text(json.dumps({"statistics": {"frames_extracted": 3, "total_detections": 4},
                                                "performance": {"02_detection": {"total_time": 1.5}}}))
    (s / "pipeline_checkpoint.json").write_text(json.dumps({"phases": {"01_extraction": {"status": "completed"},
                                                                       "02_detection": {"status": "failed"},
                                                                       "03_tracking": {}}}))
    (s / "01_extraction" / "extraction_results.csv").write_text("frame_number,timestamp\n0,2025-01-20 09:00:00\n")
    (s / "02_detection" / "detection_statistics.json").write_text(json.dumps({"total_detections": 4}))
    (s / "03_tracking" / "tracking_statistics.json").write_text(json.dumps({"unique_tracks": 2}))
    (s / "03_tracking" / "tracks.json").write_text(json.dumps({"num_tracks": 2, "tracks": [
        {"track_id": 1, "trajectory": [{"bbox": [100, 200, 40, 100]}, {"bbox": [120, 210, 40, 100]}]},
        {"track_id": 2, "trajectory": [{"bbox": [600, 300, 50, 120]}, {"frame": 3}]},
        {"track_id": 3, "trajectory": []}]}))
    if with_transform:
        (s / "04_transform" / "coordinate_transformations.json").write_text(json.dumps({"frames": [
            {"detections": [{"track_id": 1, "floor_coords_px": {"x": 10.5, "y": 20.0}},
                            {"id": 2, "floor_px": [30.0, 40.0]}, {"track_id": None, "floor_px": [1, 2]}]},
            {"det": [{"track_id": 1, "floor_coords_px": [11.0, 21.0]}]}]}))
    (s / "05_aggregation" / "zone_counts.csv").write_text("timestamp,zone_1,zone_2\n09:00,1,0\n09:05,2,1\n")
    (s / "config.yaml").write_text(yaml.safe_dump({"homography": {"matrix": H.tolist()}}))
    for name in ("a.jpg", "b.png", "c.txt"):
        (s / "06_visualization" / name).write_bytes(b"x")
    (s / "broken.json").write_text("{")
    return s


def test_session_data_loader_matches_jax(tmp_path):
    for with_transform in (True, False):
        s = _session(tmp_path / str(with_transform), with_transform)
        (s.parent / "no_metadata").mkdir()
        port, ref = SessionDataLoader(s, device="cpu"), JaxSessionDataLoader(s)
        for method in ("metadata", "summary", "checkpoint", "phase_status", "extraction_results",
                       "detection_statistics", "tracking_statistics", "tracks", "transformations", "zone_counts"):
            assert getattr(port, method)() == getattr(ref, method)(), method
        got, want = port.floor_trajectories(), ref.floor_trajectories()
        assert got.keys() == want.keys() and len(got) == 2
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3)
        assert port.images("06_visualization") == ref.images("06_visualization")
        assert port.images("06_visualization", limit=1) == ref.images("06_visualization", limit=1)
        assert port._read_json("broken.json") is None and port.images("07_none") == []
        assert SessionDataLoader.list_sessions(s.parent) == JaxSessionDataLoader.list_sessions(s.parent) == [s.name]
    run = tmp_path / "runs" / "r1"
    run.mkdir(parents=True)
    (run / "history.json").write_text(json.dumps({"step_losses": [3.0, 2.0], "epoch_losses": [2.5, None, 1.5],
                                                  "config": {"augment": True, "accum_steps": 1, "ema": 0.0},
                                                  "evals": [{"f1_score": 0.4, "map_50_95": 0.2}]}))
    assert port_dash.list_training_runs(tmp_path / "runs") == jax_dash.list_training_runs(tmp_path / "runs") == ["r1"]
    hist = port_dash.load_training_history(run)
    assert hist == jax_dash.load_training_history(run)
    assert port_dash.training_summary(hist) == jax_dash.training_summary(hist)


def test_dashboard_app_needs_streamlit_only_in_main():
    import importlib.util

    from office_person_detection_vit_torch.visualization import dashboard_app

    if importlib.util.find_spec("streamlit") is None:
        with pytest.raises(SystemExit, match="streamlit is not installed"):
            dashboard_app.main("output", device="cpu")
    assert "streamlit" not in dashboard_app.__dict__


# ------------------------------------------------------------ side-by-side video
def _image_dirs(root: Path, n: int = 5) -> tuple[Path, Path]:
    rng = np.random.default_rng(12)
    det, fm = root / "det", root / "fm"
    det.mkdir(parents=True)
    fm.mkdir()
    for i in range(n):
        stem = (T0 + timedelta(minutes=5 * i)).strftime("%Y%m%d_%H%M%S")
        cv2.imwrite(str(det / f"detection_{stem}.jpg"), rng.integers(0, 255, (180, 320, 3), np.uint8))
        if i != 2:  # one detection image without its floormap
            cv2.imwrite(str(fm / f"floormap_{stem}.png"), rng.integers(0, 255, (240, 300, 3), np.uint8))
    cv2.imwrite(str(fm / "floormap_unmatched.png"), np.zeros((10, 10, 3), np.uint8))
    return det, fm


def _video_shape(path: Path) -> tuple[int, int, int]:
    cap = cv2.VideoCapture(str(path))
    try:
        frames, shape = 0, None
        while True:
            ok, img = cap.read()
            if not ok:
                break
            frames, shape = frames + 1, img.shape
    finally:
        cap.release()
    return frames, *shape[:2]


def test_side_by_side_exporter_matches_jax(tmp_path):
    det, fm = _image_dirs(tmp_path)
    port, ref = SideBySideVideoExporter(fps=2.0, height=240), JaxSideBySideVideoExporter(fps=2.0, height=240)
    assert port.pair_images(det, fm) == ref.pair_images(det, fm) and len(port.pair_images(det, fm)) == 4
    img = cv2.imread(str(next(fm.glob("floormap_2*.png"))))
    for pts in ([], [(30.0, 40.0), (90.0, 200.0)], [(150.0, 120.0)], [(-5.0, 10.0), (299.0, 239.0)]):
        for kw in ({}, {"target_size": (300, 240)}, {"zoom_margin": 0.2, "min_zoom_ratio": 0.1}):
            got = port.crop_and_zoom_floormap(img, pts, **kw)
            assert np.array_equal(got, ref.crop_and_zoom_floormap(img, pts, **kw)), (pts, kw)
    key = (T0 + timedelta(minutes=5)).strftime("%Y%m%d_%H%M%S")
    for zoom in (None, {key: [(40.0, 50.0), (60.0, 70.0)]}):
        got = port.export(det, fm, tmp_path / "p.mp4", floor_points_by_key=zoom)
        want = ref.export(det, fm, tmp_path / "j.mp4", floor_points_by_key=zoom)
        assert _video_shape(got) == _video_shape(want) and _video_shape(got)[:2] == (4, 240)
    assert port.export(det, tmp_path / "empty_dir_missing", tmp_path / "none.mp4") is None


def test_visualization_phase_writes_the_side_by_side_video_as_jax(tmp_path):
    rng = np.random.default_rng(13)
    cfg = ConfigManager.from_dict({"zones": [{"id": "zone_1", "polygon": [[0, 0], [900, 0], [900, 900], [0, 900]]}],
                                   "output": {"save_floormap_images": True, "save_side_by_side_video": True,
                                              "side_by_side_video_fps": 2.0, "side_by_side_zoom": True}})
    made = {}
    for name, cls, dto in (("port", VisualizationPhase, port_dto), ("jax", JaxVisualizationPhase, jax_dto)):
        frs = []
        for i in range(3):
            d = dto.Detection(bbox=(100.0 + 10 * i, 100.0, 50.0, 120.0), confidence=0.9)
            d.floor_coords_px = (400.0 + 30 * i, 500.0)
            frs.append(dto.FrameResult(i, T0 + timedelta(minutes=5 * i), [d]))
        det_dir = tmp_path / name / "02_detection"
        det_dir.mkdir(parents=True)
        for fr in frs:
            cv2.imwrite(str(det_dir / f"detection_{fr.timestamp_stem}.jpg"),
                        rng.integers(0, 255, (72, 128, 3), np.uint8))
        out = cls(cfg).execute(frs, [], tmp_path / name / "06", detection_image_dir=det_dir)
        made[name] = (sorted(out), _video_shape(out["side_by_side"]))
    assert made["port"] == made["jax"] and made["port"][1][0] == 3


def test_trajectory_exporter_imagery_matches_jax(tmp_path):
    rng = np.random.default_rng(14)
    images = [rng.integers(0, 255, (90, 160, 3), np.uint8) for _ in range(3)]
    files = {}
    for name, cls, dto in (("port", TrajectoryExporter, port_dto), ("jax", JaxTrajectoryExporter, jax_dto)):
        frs = [dto.FrameResult(i, T0, [dto.Detection(bbox=(10.0 + i, 20.0, 30.0, 40.0), confidence=0.8, track_id=i),
                                       dto.Detection(bbox=(90.0, 10.0, 20.0, 50.0), confidence=0.5)])
               for i in range(3)]
        ex = cls(tmp_path / name)
        paths = ex.export_image_sequence(frs, images, prefix="t")
        video = ex.export_video(frs, images, name="t.mp4", fps=3.0)
        assert ex.export_video(frs, [], name="none.mp4") is None
        files[name] = ([p.name for p in paths], [p.read_bytes() for p in paths], _video_shape(video))
    assert files["port"] == files["jax"] and files["port"][2] == (3, 90, 160)


# ------------------------------------------------------------ attention overlays
def test_attention_overlays_match_jax(tmp_path, monkeypatch):
    from office_person_detection_vit_torch.visualization.visualizer import Visualizer
    from office_person_detection_vit_tpu.visualization.visualizer import Visualizer as JaxVisualizer

    people = [[(500, 350, 2)], [(150, 200, 0), (900, 150, 1)]]
    frames = [render_frame(T0 + timedelta(minutes=5 * i), people=p, seed=4 + i) for i, p in enumerate(people)]
    cfg = ConfigManager.from_dict({"detection": SMALL | {"batch_size": 2}, "parallel": {"mesh": {"data": 1}},
                                   "output": {"save_attention_maps": True}})
    drawn = {}
    for name, cls, dto, viz in (("port", DetectionPhase, port_dto, Visualizer),
                                ("jax", JaxDetectionPhase, jax_dto, JaxVisualizer)):
        overlay = viz.overlay_attention_map
        monkeypatch.setattr(viz, "overlay_attention_map",
                            lambda self, *a, _f=overlay, _n=name, **kw: drawn.setdefault(_n, []).append(
                                _f(self, *a, **kw)) or drawn[_n][-1])
        results = [dto.FrameResult(i, T0 + timedelta(minutes=5 * i)) for i in range(len(frames))]
        cls(cfg).execute(frames, results, tmp_path / name)
    names = sorted(p.name for p in (tmp_path / "jax").glob("attention_*.jpg"))
    assert len(names) == 2 and names == sorted(p.name for p in (tmp_path / "port").glob("attention_*.jpg"))
    assert len(drawn["port"]) == len(drawn["jax"]) == 2
    for got, want in zip(drawn["port"], drawn["jax"]):
        assert got.shape == want.shape == (720, 1280 + 24, 3)
        assert np.abs(got.astype(np.int16) - want).max() <= 2
    for n in names:  # JPEG of overlays 2 grey levels apart: decoded within 4
        got, want = (cv2.imread(str(tmp_path / d / n)).astype(np.int16) for d in ("port", "jax"))
        assert got.shape == want.shape and np.abs(got - want).max() <= 4, n


def test_attention_overlays_stop_at_a_detector_without_maps(tmp_path):
    class NoMaps:
        model = object()
        transfer_format = None

        def detect_batch(self, frames):
            return port_dto.detections_to_batch([[] for _ in frames])

        def get_attention_map(self, frame):
            return None

        def cleanup(self):
            pass

    frames = [np.zeros((72, 128, 3), np.uint8)] * 2
    results = [port_dto.FrameResult(i, T0 + timedelta(minutes=i)) for i in range(2)]
    cfg = ConfigManager.from_dict({"detection": {"device": "cpu"}, "output": {"save_attention_maps": True}})
    DetectionPhase(cfg, detector=NoMaps()).execute(frames, results, tmp_path)
    assert not list(tmp_path.glob("attention_*.jpg")) and (tmp_path / "detections.json").exists()


# ------------------------------------------------------------ feature visualizer
def _blobs(n_ids: int = 5, per_id: int = 12, dim: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = np.repeat(np.arange(n_ids), per_id)
    centers = rng.normal(size=(n_ids, dim)) * 3.0
    return (centers[ids] + rng.normal(size=(len(ids), dim))).astype(np.float32), ids


def test_feature_visualizer_clusters_as_sklearn():
    from sklearn.cluster import KMeans
    from sklearn.metrics import silhouette_score

    x, ids = _blobs()
    vis = FeatureVisualizer(random_state=0, device="cpu")
    labels, score = vis.cluster(x, 5)
    ref = KMeans(n_clusters=5, random_state=0, n_init=10).fit(x)
    pairs = set(zip(labels.tolist(), ref.labels_.tolist()))
    assert len(pairs) == 5 == len(set(labels.tolist()))  # equal up to a permutation
    _, inertia = port_fv.kmeans(torch.from_numpy(x).double(), 5, torch.Generator().manual_seed(0))
    assert inertia == pytest.approx(ref.inertia_, rel=1e-4)
    assert score == pytest.approx(silhouette_score(x, ref.labels_), abs=1e-6)
    for lab in (ids, (ids + np.arange(len(ids))) % 4, np.r_[0, np.ones(len(ids) - 1, int)]):  # a singleton too
        got = port_fv.silhouette(torch.from_numpy(x).double(), torch.from_numpy(lab))
        assert got == pytest.approx(silhouette_score(x, lab), abs=1e-6)
    report, want = vis.quality_report(x, ids), JaxFeatureVisualizer().quality_report(x, ids)
    assert report.keys() == want.keys()
    for k in report:
        assert report[k] == pytest.approx(want[k], abs=1e-6), k


def test_feature_visualizer_tsne_against_sklearn(tmp_path):
    from sklearn.metrics import silhouette_score
    from threadpoolctl import threadpool_limits

    x, ids = _blobs()
    vis = FeatureVisualizer(random_state=0, device="cpu")
    emb = vis.project_tsne(x)
    with threadpool_limits(2):
        ref = JaxFeatureVisualizer().project_tsne(x)
    perplexity = max(2.0, min(30.0, (len(x) - 1) / 3))
    P = port_fv.joint_probabilities(port_fv.squared_distances(torch.from_numpy(x).double()), perplexity)
    kl, kl_ref = (float(port_fv.kl_divergence(P, torch.from_numpy(np.asarray(e)).double(), False)[0])
                  for e in (emb, ref))
    assert emb.shape == (len(x), 2) and emb.dtype == np.float32
    assert kl <= 1.05 * kl_ref + 0.05, (kl, kl_ref)
    assert silhouette_score(emb, ids) >= 0.5
    out = vis.plot_embedding(x, ids, tmp_path / "emb.png")
    assert cv2.imread(str(out)).shape == (960, 960, 3)
