"""The port's Phase 3-4 compute against the JAX package, on the CPU in float32.

Same inputs, made from a seed with numpy, through both packages:

- ``ops/geometry.py`` (``px_to_mm``, ``in_bounds_mask``, ``undistort_points``,
  ``distort_points``, ``reprojection_errors``), ``ops/pwa.py``
  (``pwa_transform``, ``tps_transform``) and the three transformers'
  ``transform_batch``: 1e-3 px at coordinates up to 2000 px, with points
  outside the PWA hull and on a triangle edge; the fits exactly (the same
  float64 numpy); the three transformers' ``transform_detections`` (the
  floor pixels and millimetres written onto detections) within 1e-3 px;
- ``LensDistortionCorrector`` and ``DistortionParams.from_config`` (both
  config layouts);
- ``ops/aggregation.py`` (``zone_statistics``, ``linear_trend``,
  ``top_k_peaks``): rtol 1e-6, peak indices equal; ``Aggregator`` and its
  ``zone_counts.csv``: byte-identical;
- the pickle trap: a PWA model saved by the JAX package loads in the port,
  and a process that loads it imports nothing of the JAX package.
"""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.aggregation.aggregator import Aggregator
from office_person_detection_vit_torch.calibration.lens_distortion import DistortionParams, LensDistortionCorrector
from office_person_detection_vit_torch.core import dto as port_dto
from office_person_detection_vit_torch.ops import aggregation as port_agg
from office_person_detection_vit_torch.ops import geometry as port_geo
from office_person_detection_vit_torch.ops import pwa as port_pwa
from office_person_detection_vit_torch.transform import piecewise_affine as port_pa
from office_person_detection_vit_torch.transform.floormap_config import FloorMapConfig
from office_person_detection_vit_torch.transform.homography import HomographyTransformer
from office_person_detection_vit_torch.zone.zone_classifier import ZoneClassifier
from office_person_detection_vit_tpu.aggregation.aggregator import Aggregator as JaxAggregator
from office_person_detection_vit_tpu.calibration import lens_distortion as jax_lens
from office_person_detection_vit_tpu.core import dto as jax_dto
from office_person_detection_vit_tpu.ops import aggregation as jax_agg
from office_person_detection_vit_tpu.ops import geometry as jax_geo
from office_person_detection_vit_tpu.ops import pwa as jax_pwa
from office_person_detection_vit_tpu.transform import piecewise_affine as jax_pa
from office_person_detection_vit_tpu.transform.floormap_config import FloorMapConfig as JaxFloorMapConfig
from office_person_detection_vit_tpu.transform.homography import HomographyTransformer as JaxHomographyTransformer
from office_person_detection_vit_tpu.zone.zone_classifier import ZoneClassifier as JaxZoneClassifier
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

REPO = Path(__file__).resolve().parent.parent
PX_TOL = 1e-3
H = np.array([
    [-0.8795888447, -2.8974379541, 417.8510123786],
    [-1.5459702925, -3.4570021203, 1054.0107447082],
    [-0.0011928509, -0.0035480452, 1.0000000000],
])
K = np.array([[1250.0, 0.0, 640.0], [0.0, 1250.0, 360.0], [0.0, 0.0, 1.0]])
DIST = np.array([-0.12, 0.03, 1.5e-3, -8e-4, 0.0])  # k1, k2, p1, p2, k3
LENS = {"k1": -0.12, "k2": 0.03, "p1": 1.5e-3, "p2": -8e-4}


def t32(a):
    return torch.tensor(np.asarray(a, np.float32))


def close_px(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=PX_TOL)


@pytest.fixture(scope="module")
def points():
    """2000 points over [0, 2000)^2."""
    return np.random.default_rng(0).uniform(0, 2000, (2000, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def camera_points():
    """Points of a 1280x720 frame whose floor point under H lies on the
    1878x1369 floormap, the transform's domain (H sends much of the frame
    towards its horizon)."""
    points = np.random.default_rng(7).uniform(0, [1280, 720], (8000, 2)).astype(np.float32)
    hom = np.c_[points.astype(np.float64), np.ones(len(points))] @ H.T
    floor = hom[:, :2] / hom[:, 2:]
    return points[(floor >= 0).all(axis=1) & (floor < [1878, 1369]).all(axis=1) & (hom[:, 2] > 0)]


@pytest.fixture(scope="module")
def correspondences():
    """30 scattered camera points of a 1280x720 frame and their floor points
    under an affine map plus a smooth bend (so that PWA and TPS differ from
    an affine map); floor coordinates stay within about 2000 px."""
    rng = np.random.default_rng(1)
    src = rng.uniform([40, 40], [1240, 680], (30, 2))
    dst = src @ np.array([[1.3, 0.2], [-0.1, 1.6]]).T + [50.0, 80.0] + 15 * np.sin(src / 300.0)
    return src, dst


# ------------------------------------------------------------------ geometry
def test_px_to_mm_and_bounds_match_jax(points):
    origin, scale = np.float32([7.0, 9.0]), np.float32([28.19, 28.24])
    close_px(port_geo.px_to_mm(t32(points), t32(origin), t32(scale)),
             jax_geo.px_to_mm(jnp.asarray(points), jnp.asarray(origin), jnp.asarray(scale)))
    np.testing.assert_array_equal(port_geo.in_bounds_mask(t32(points), 1878.0, 1369.0).numpy(),
                                  np.asarray(jax_geo.in_bounds_mask(jnp.asarray(points), 1878.0, 1369.0)))


@pytest.mark.parametrize("num_iters", [10, 20])
def test_undistort_points_matches_jax(points, num_iters):
    want = jax_geo.undistort_points(jnp.asarray(points), jnp.asarray(K, jnp.float32), jnp.asarray(DIST, jnp.float32),
                                    num_iters=num_iters)
    close_px(port_geo.undistort_points(t32(points), t32(K), t32(DIST), num_iters=num_iters), want)


def test_distort_points_matches_jax(points):
    want = jax_geo.distort_points(jnp.asarray(points), jnp.asarray(K, jnp.float32), jnp.asarray(DIST, jnp.float32))
    close_px(port_geo.distort_points(t32(points), t32(K), t32(DIST)), want)


def test_reprojection_errors_match_jax(points):
    dst = points + np.random.default_rng(2).normal(0, 3, points.shape).astype(np.float32)
    want = jax_geo.reprojection_errors(jnp.asarray(H, jnp.float32), jnp.asarray(points), jnp.asarray(dst))
    got = port_geo.reprojection_errors(t32(H), t32(points), t32(dst))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=PX_TOL)


# ----------------------------------------------------------------- PWA / TPS
def _query_points(model, points):
    """The random points (most outside the hull), the correspondences, and
    the midpoint of every triangle's first edge (on a triangle edge)."""
    tri = model.triangles
    edge_mid = (tri[:, 0] + tri[:, 1]) / 2
    return np.concatenate([points, model.src_points, edge_mid]).astype(np.float32)


def test_fit_pwa_matches_jax(correspondences):
    src, dst = correspondences
    got, want = port_pwa.fit_pwa(src, dst), jax_pwa.fit_pwa(src, dst)
    for name in ("triangles", "affines", "centroids", "src_points", "dst_points"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_pwa_transform_matches_jax(correspondences, points):
    model = jax_pwa.fit_pwa(*correspondences)
    q = _query_points(model, points)
    args = (model.triangles, model.affines, model.centroids)
    want = jax_pwa.pwa_transform(jnp.asarray(q), *map(jnp.asarray, args))
    close_px(port_pwa.pwa_transform(t32(q), *map(torch.from_numpy, args)), want)


def test_tps_fit_and_transform_match_jax(correspondences, points):
    got, want = port_pwa.fit_tps(*correspondences), jax_pwa.fit_tps(*correspondences)
    for name in ("control", "w", "a", "offset"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.scale == want.scale
    q = np.concatenate([points, got.control * got.scale + got.offset]).astype(np.float32)
    j = jax_pwa.tps_transform(jnp.asarray(q), *(jnp.asarray(a) for a in (want.control, want.w, want.a, want.offset)),
                              jnp.float32(want.scale))
    p = port_pwa.tps_transform(t32(q), *(torch.from_numpy(a) for a in (got.control, got.w, got.a, got.offset)),
                               torch.tensor(got.scale, dtype=torch.float32))
    close_px(p, j)


# -------------------------------------------------------------- transformers
def test_homography_transformer_matches_jax(camera_points):
    fm = dict(image_width=1878, image_height=1369)
    port = HomographyTransformer(H, FloorMapConfig(**fm), device="cpu")
    jax_t = JaxHomographyTransformer(H, JaxFloorMapConfig(**fm))
    assert len(camera_points) > 100
    close_px(port.transform_batch(camera_points), jax_t.transform_batch(camera_points))
    floor = jax_t.transform_batch(camera_points)
    np.testing.assert_array_equal(port.is_in_bounds(floor), jax_t.is_in_bounds(floor))
    assert port.get_info() == jax_t.get_info()
    assert port.transform_pixel(640.0, 500.0) == pytest.approx(jax_t.transform_pixel(640.0, 500.0), abs=PX_TOL)


@pytest.mark.parametrize("undistort", [False, True], ids=["plain", "undistorted"])
def test_pwa_transformer_matches_jax(correspondences, points, undistort):
    src, dst = correspondences
    params = dict(LENS) if undistort else {}
    port_und = LensDistortionCorrector(DistortionParams(**params), device="cpu") if undistort else None
    jax_und = jax_lens.LensDistortionCorrector(jax_lens.DistortionParams(**params)) if undistort else None
    port = port_pa.PiecewiseAffineTransformer(src, dst, undistorter=port_und, device="cpu")
    jax_t = jax_pa.PiecewiseAffineTransformer(src, dst, undistorter=jax_und)
    q = _query_points(port.model, points)
    if undistort:
        # Each package fits on its own float32 undistortion of src, which
        # differ in the last bits; an affine extrapolated far beyond its
        # triangle magnifies that, so the queries stay in the camera frame
        # (the hull's margin of 40 px is still outside it).
        q = q[(q[:, 0] < 1280) & (q[:, 1] < 720)]
    close_px(port.transform_batch(q), jax_t.transform_batch(q))
    got, want = port.get_info(), jax_t.get_info()
    assert {k: v for k, v in got.items() if k != "training_error"} == {k: v for k, v in want.items() if k != "training_error"}
    for k, v in want["training_error"].items():
        assert got["training_error"][k] == pytest.approx(v, abs=PX_TOL)


def test_tps_transformer_matches_jax(correspondences, points):
    port = port_pa.ThinPlateSplineTransformer(*correspondences, device="cpu")
    jax_t = jax_pa.ThinPlateSplineTransformer(*correspondences)
    close_px(port.transform_batch(points), jax_t.transform_batch(points))
    got, want = port.get_info(), jax_t.get_info()
    assert got["method"] == want["method"] and got["num_points"] == want["num_points"]
    for k, v in want["training_error"].items():
        assert got["training_error"][k] == pytest.approx(v, abs=PX_TOL)


def _transformer_pair(method, correspondences):
    """The port's and the JAX package's transformer of one method, on the
    reference floormap (origin 7, 9 px; about 28.2 mm a pixel)."""
    src, dst = correspondences
    if method == "homography":
        return HomographyTransformer(H, FloorMapConfig(), device="cpu"), JaxHomographyTransformer(H, JaxFloorMapConfig())
    if method == "piecewise_affine":
        return (port_pa.PiecewiseAffineTransformer(src, dst, FloorMapConfig(), device="cpu"),
                jax_pa.PiecewiseAffineTransformer(src, dst, JaxFloorMapConfig()))
    return (port_pa.ThinPlateSplineTransformer(src, dst, FloorMapConfig(), device="cpu"),
            jax_pa.ThinPlateSplineTransformer(src, dst, JaxFloorMapConfig()))


@pytest.mark.parametrize("method", ["homography", "piecewise_affine", "thin_plate_spline"])
def test_transform_detections_matches_jax(camera_points, correspondences, method):
    port, jax_t = _transformer_pair(method, correspondences)
    feet = camera_points[:300] if method == "homography" else \
        np.random.default_rng(4).uniform([0, 0], [1280, 720], (300, 2)).astype(np.float32)
    wh = np.random.default_rng(5).uniform([30, 80], [70, 200], (len(feet), 2))
    made = {}
    for name, dto in (("port", port_dto), ("jax", jax_dto)):
        made[name] = [dto.Detection(bbox=(float(x - w / 2), float(y - h), float(w), float(h)), confidence=0.9,
                                    zone_ids=["kept"]) for (x, y), (w, h) in zip(feet, wh)]
    got, want = port.transform_detections(made["port"]), jax_t.transform_detections(made["jax"])
    assert got is made["port"] and port.transform_detections([]) == []
    close_px([d.floor_coords_px for d in got], [d.floor_coords_px for d in want])
    mm_tol = PX_TOL * float(FloorMapConfig().mm_per_px.max())
    np.testing.assert_allclose([d.floor_coords_mm for d in got], [d.floor_coords_mm for d in want], rtol=0, atol=mm_tol)
    assert all(d.zone_ids == ["kept"] for d in got)  # no classifier given: zones untouched, as in JAX
    if method == "homography":
        one = port.transform_detection(port_dto.Detection(bbox=made["port"][0].bbox, confidence=0.9))
        close_px(one.floor_coords_px, want[0].floor_coords_px)


@pytest.mark.parametrize("method", ["homography", "piecewise_affine", "thin_plate_spline"])
def test_build_transformer_matches_jax(tmp_path, correspondences, method):
    src, dst = correspondences
    corr = tmp_path / "corr.json"
    corr.write_text(json.dumps({"camera": src.tolist(), "floormap": dst.tolist()}))
    cfg = {"transform.method": method, "homography.matrix": H.tolist(), "calibration.correspondence_file": str(corr),
           "detection.device": "cpu", "floormap.image_width": 1000}
    port, jax_t = port_pa.build_transformer(cfg), jax_pa.build_transformer(cfg)
    assert port.method == jax_t.method == method and port.device.type == "cpu"
    assert port.floormap.image_width == 1000
    q = np.random.default_rng(3).uniform([0, 300], [1280, 720], (64, 2)).astype(np.float32)
    close_px(port.transform_batch(q), jax_t.transform_batch(q))


# ------------------------------------------------------------------------ lens
@pytest.mark.parametrize(
    "cfg",
    [
        {f"transform.lens_distortion.{k}": v for k, v in LENS.items()} | {"transform.lens_distortion.center_x": 600.0},
        {"calibration.distortion": {}, **{f"calibration.distortion.{k}": v for k, v in LENS.items()},
         "calibration.intrinsics.principal_point_x": 620.0, "calibration.intrinsics.focal_length_y": 1200.0},
        {},
    ],
    ids=["flat_keys", "calibration_layout", "identity"],
)
def test_lens_corrector_matches_jax(cfg, points):
    port, jax_c = LensDistortionCorrector.from_config(cfg, device="cpu"), jax_lens.LensDistortionCorrector.from_config(cfg)
    assert port.params.__dict__ == jax_c.params.__dict__
    close_px(port.undistort_points(points), jax_c.undistort_points(points))
    close_px(port.distort_points(points), jax_c.distort_points(points))
    assert port.undistort_point(100.0, 50.0) == pytest.approx(jax_c.undistort_point(100.0, 50.0), abs=PX_TOL)


# ---------------------------------------------------------------- zones
@pytest.mark.parametrize("mode", ["all", "priority"])
def test_zone_classifier_facade_matches_jax(mode, points):
    zones = [
        {"id": "a", "polygon": [[0, 0], [1200, 0], [1200, 1200], [0, 1200]], "priority": 2},
        {"id": "b", "polygon": [[800, 800], [1900, 700], [1500, 1900]], "priority": 1},
    ]
    port, jax_z = ZoneClassifier(zones, overlap_mode=mode, device="cpu"), JaxZoneClassifier(zones, overlap_mode=mode)
    assert port.classify_batch(points) == jax_z.classify_batch(points)
    assert port.classify_batch(torch.from_numpy(points)) == jax_z.classify_batch(points)
    assert port.classify_with_unclassified(points[:50]) == jax_z.classify_with_unclassified(points[:50])


# ------------------------------------------------------------- aggregation
@pytest.fixture(scope="module")
def counts():
    """(F, Z) counts with ties in the frame totals."""
    c = np.random.default_rng(4).integers(0, 6, (37, 4)).astype(np.int32)
    c[5] = c[9] = c[30] = [9, 9, 9, 9]  # three frames tie for the top total
    return c


def test_zone_statistics_match_jax(counts):
    got = port_agg.zone_statistics(torch.from_numpy(counts))
    want = jax_agg.zone_statistics(jnp.asarray(counts))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("frames", [37, 1, 2])
def test_linear_trend_matches_jax(counts, frames):
    got = port_agg.linear_trend(torch.from_numpy(counts[:frames]))
    want = jax_agg.linear_trend(jnp.asarray(counts[:frames]))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("k", [1, 3, 5, 40])
def test_top_k_peaks_match_jax(counts, k):
    gi, gv = port_agg.top_k_peaks(torch.from_numpy(counts), k=k)
    wi, wv = jax_agg.top_k_peaks(jnp.asarray(counts), k=k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-6)


def test_aggregator_and_csv_match_jax(tmp_path, counts):
    ids = ["z1", "z2", "z3"]
    rng = np.random.default_rng(5)
    port, jax_a = Aggregator(ids, device="cpu"), JaxAggregator(ids)
    for f in range(12):
        ts = f"2025-01-20 09:{5 * f:02d}:00"
        per_det = [list(rng.choice(ids + ["elsewhere"], size=rng.integers(0, 3), replace=False))
                   for _ in range(rng.integers(0, 6))]
        got, want = port.aggregate_frame(ts, per_det), jax_a.aggregate_frame(ts, per_det)
        assert got.__dict__ == want.__dict__
    membership = rng.random((4, 7, 3)) < 0.4
    valid = rng.random((4, 7)) < 0.7
    stamps = [f"2025-01-20 10:{m:02d}:00" for m in range(4)]
    port.aggregate_membership(stamps, membership, valid)
    jax_a.aggregate_membership(stamps, membership, valid)
    np.testing.assert_array_equal(port.counts_matrix, jax_a.counts_matrix)
    assert port.get_zone_counts() == jax_a.get_zone_counts()
    assert port.get_peak_times(4) == jax_a.get_peak_times(4)
    for got, want in ((port.get_statistics(), jax_a.get_statistics()),
                      (port.get_trend_analysis(), jax_a.get_trend_analysis())):
        assert got.keys() == want.keys()
        for z in want:
            for k, v in want[z].items():
                assert got[z][k] == (v if isinstance(v, str) else pytest.approx(v, rel=1e-6, abs=1e-6))
    a, b = port.export_csv(tmp_path / "port.csv"), jax_a.export_csv(tmp_path / "jax.csv")
    assert a.read_bytes() == b.read_bytes()
    port.reset()
    assert port.get_statistics() == {} and port.get_peak_times() == [] and port.get_trend_analysis() == {}


# -------------------------------------------------------------- the pickle trap
def test_pwa_model_saved_by_jax_loads_in_the_port(tmp_path, correspondences):
    src, dst = correspondences
    path = tmp_path / "pwa.pkl"
    jax_t = jax_pa.PiecewiseAffineTransformer(src, dst, floormap=JaxFloorMapConfig(image_width=1500))
    jax_t.save(path)
    port = port_pa.PiecewiseAffineTransformer.load(path, device="cpu")
    assert isinstance(port.floormap, FloorMapConfig) and port.floormap.image_width == 1500
    q = np.random.default_rng(6).uniform(0, 1280, (100, 2)).astype(np.float32)
    close_px(port.transform_batch(q), jax_t.transform_batch(q))
    port.save(tmp_path / "port.pkl")  # the same dict, with the port's class
    again = port_pa.PiecewiseAffineTransformer.load(tmp_path / "port.pkl", device="cpu")
    np.testing.assert_array_equal(again.model.triangles, port.model.triangles)
    assert again.floormap == port.floormap

    # A fresh process loads it with nothing of the JAX package imported.
    code = (
        "import sys, numpy as np\n"
        "from office_person_detection_vit_torch.transform.piecewise_affine import PiecewiseAffineTransformer\n"
        f"t = PiecewiseAffineTransformer.load({str(path)!r}, device='cpu')\n"
        "assert t.floormap.image_width == 1500\n"
        "print(sorted(m for m in sys.modules if m.startswith('office_person_detection_vit_tpu') or m == 'jax'))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_pwa_model_load_refuses_other_globals(tmp_path):
    path = tmp_path / "evil.pkl"
    path.write_bytes(pickle.dumps({"src_points": subprocess.Popen}))
    with pytest.raises(pickle.UnpicklingError, match="subprocess.Popen"):
        port_pa.PiecewiseAffineTransformer.load(path, device="cpu")
