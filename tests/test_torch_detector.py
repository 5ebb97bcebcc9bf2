"""The whole slice: port DETRDetector and the Phase 3-4 compute against the
JAX package.

Both detectors run the tiny tier on the CPU in float32 with the same weights
(the JAX detector's init, written as a path-keyed npz and read by the port),
``nms_threshold`` 0.4, and a tail chunk that exercises a power-of-two bucket.
Boxes and foot points agree to 1e-3 px, scores to 1e-5, valid flags exactly.
The Phase 3-4 functions then take the same points: floor coordinates agree to
1e-5 relative, zone membership and counts exactly. ``detection.transfer_format``:
the port's ``i420`` and ``i420d`` give the same detections bit for bit, within
the same bars of the JAX detector's ``i420``; ``auto`` races the three formats
and keeps one of them.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.core.dto import Detection, detections_to_batch
from office_person_detection_vit_torch.detection.detector import TRANSFER_FORMATS, DETRDetector, check_transfer_format
from office_person_detection_vit_torch.device import resolve_device
from office_person_detection_vit_torch.models.detr import DETRConfig
from office_person_detection_vit_torch.ops import aggregation as port_agg
from office_person_detection_vit_torch.ops import geometry as port_geo
from office_person_detection_vit_torch.ops import zones as port_zones
from office_person_detection_vit_tpu.config.config_manager import ConfigManager
from office_person_detection_vit_tpu.core import dto as jax_dto
from office_person_detection_vit_tpu.detection.detector import DETRDetector as JaxDETRDetector
from office_person_detection_vit_tpu.detection.export import save_weights_npz
from office_person_detection_vit_tpu.models.detr import DETRConfig as JaxDETRConfig
from office_person_detection_vit_tpu.ops import aggregation as jax_agg
from office_person_detection_vit_tpu.ops import geometry as jax_geo
from office_person_detection_vit_tpu.ops import zones as jax_zones
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)


DETECTION = {
    "confidence_threshold": 0.3, "nms_threshold": 0.4, "batch_size": 2,
    "input_height": 96, "input_width": 128, "dtype": "float32", "device": "cpu",
    "transfer_format": "bgr",
}


@pytest.fixture(scope="module")
def slice_outputs(tmp_path_factory):
    jax_det = JaxDETRDetector(
        ConfigManager.from_dict({"detection": DETECTION, "parallel": {"mesh": {"data": 1}}}),
        detr_config=JaxDETRConfig.tiny(num_classes=2),
    )
    jax_det.load_model()
    path = tmp_path_factory.mktemp("w") / "tiny.npz"
    save_weights_npz(jax_det.variables, path)
    port_det = DETRDetector(
        {f"detection.{k}": v for k, v in DETECTION.items()} | {"detection.checkpoint_path": str(path)},
        detr_config=DETRConfig.tiny(num_classes=2),
    )
    frames = np.random.default_rng(0).integers(0, 256, (5, 120, 160, 3), np.uint8)
    return jax_det.detect_batch(frames), port_det.detect_batch(frames), port_det


def test_detect_batch_matches_jax(slice_outputs):
    want, got, port_det = slice_outputs
    assert port_det._tail_bucket(1) == 1 and port_det._bucket_sizes() == [1, 2]
    assert got.boxes_xywh.shape == (5, 10, 4) and isinstance(got.valid, np.ndarray)
    np.testing.assert_array_equal(got.valid, np.asarray(want.valid))
    assert got.valid.any() and not got.valid.all()
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-5)
    np.testing.assert_allclose(got.boxes_xywh, np.asarray(want.boxes_xywh), atol=1e-3)
    np.testing.assert_allclose(got.foot, np.asarray(want.foot), atol=1e-3)


def test_frame_results_match_jax(slice_outputs):
    want, got, _ = slice_outputs
    for fw, fg in zip(want.to_frame_results(), got.to_frame_results()):
        assert len(fw.detections) == len(fg.detections)
        for dw, dg in zip(fw.detections, fg.detections):
            np.testing.assert_allclose(dg.bbox, dw.bbox, atol=1e-3)
            np.testing.assert_allclose(dg.foot_point, dw.foot_point, atol=1e-3)


def _floor_points(H, batch):
    """Foot points scaled into the camera frame the homography expects, plus
    the inverse images of points in and around the zones."""
    foot = np.asarray(batch.foot, np.float32).reshape(-1, 2) * 8.0
    floor_targets = np.asarray([[977, 1131], [1213, 1000], [1449, 1300], [700, 1000], [1095, 1200]], np.float64)
    inv = np.linalg.inv(H)
    h = np.c_[floor_targets, np.ones(len(floor_targets))] @ inv.T
    return np.concatenate([foot, (h[:, :2] / h[:, 2:]).astype(np.float32)])


def test_phase_3_4_match_jax(slice_outputs, homography_matrix, zones_config):
    want_batch, got_batch, _ = slice_outputs
    port_geo.validate_homography(homography_matrix)
    pts = _floor_points(homography_matrix, got_batch)
    H32 = homography_matrix.astype(np.float32)
    floor_t = port_geo.homography_transform(torch.from_numpy(H32), torch.from_numpy(pts)).numpy()
    floor_j = np.asarray(jax_geo.homography_transform(jnp.asarray(H32), jnp.asarray(pts)))
    np.testing.assert_allclose(floor_t, floor_j, rtol=1e-5)

    got_zc = port_zones.ZoneClassifier(zones_config, device="cpu")
    want_zc = jax_zones.ZoneClassifier(zones_config)
    m_t, m_j = got_zc.membership(floor_j), want_zc.membership(floor_j)
    np.testing.assert_array_equal(m_t, m_j)
    assert m_t.any()
    assert got_zc.classify_batch(floor_j) == want_zc.classify_batch(floor_j)
    assert got_zc.classify_with_unclassified(floor_j) == want_zc.classify_with_unclassified(floor_j)

    F = want_batch.valid.shape[0]
    membership = m_t[: F * 10].reshape(F, 10, -1)
    valid = got_batch.valid | np.eye(F, 10, dtype=bool)
    np.testing.assert_array_equal(
        port_agg.zone_count_matrix(torch.from_numpy(membership), torch.from_numpy(valid)).numpy(),
        np.asarray(jax_agg.zone_count_matrix(jnp.asarray(membership), jnp.asarray(valid))),
    )
    np.testing.assert_array_equal(
        port_agg.unclassified_counts(torch.from_numpy(membership), torch.from_numpy(valid)).numpy(),
        np.asarray(jax_agg.unclassified_counts(jnp.asarray(membership), jnp.asarray(valid))),
    )


def test_priority_mode_matches_jax(zones_config):
    overlapping = zones_config + [
        {"id": "zone_4", "polygon": [[1000, 900], [1200, 900], [1200, 1400], [1000, 1400]], "priority": 0}
    ]
    pts = np.asarray([[977, 1131], [1100, 1000], [1449, 1300], [10, 10]], np.float32)
    got = port_zones.ZoneClassifier(overlapping, overlap_mode="priority", device="cpu")
    want = jax_zones.ZoneClassifier(overlapping, overlap_mode="priority")
    assert got.classify_batch(pts) == want.classify_batch(pts)
    assert got.classify((1100.0, 1000.0)) == want.classify((1100.0, 1000.0)) == ["zone_4"]
    m = got.membership(pts)
    np.testing.assert_array_equal(
        port_zones.classify_priority(torch.from_numpy(m), torch.from_numpy(got.packed.priorities)).numpy(),
        np.asarray(jax_zones.classify_priority(jnp.asarray(m), jnp.asarray(want.packed.priorities))),
    )


def test_detections_to_batch_matches_jax():
    frames = [[Detection(bbox=(10.0, 20.0, 30.0, 40.0), confidence=0.9)], []]
    jframes = [[jax_dto.Detection(bbox=(10.0, 20.0, 30.0, 40.0), confidence=0.9)], []]
    got, want = detections_to_batch(frames, capacity=4), jax_dto.detections_to_batch(jframes, capacity=4)
    for name in ("boxes_xywh", "scores", "valid", "foot"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))


@pytest.mark.parametrize("bad", [np.eye(2), np.zeros((3, 3))])
def test_validate_homography_raises(bad):
    with pytest.raises(ValueError):
        port_geo.validate_homography(bad)


@pytest.mark.parametrize("pref", ["auto", "cuda"])
def test_cuda_request_without_a_card_raises(pref):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(pref)
    det = DETRDetector({"detection.device": pref, "detection.model_size": "tiny"})
    with pytest.raises(RuntimeError, match="CUDA"):
        det.load_model()
    square = [{"id": "z", "polygon": [[0, 0], [1, 0], [1, 1]]}]
    with pytest.raises(RuntimeError, match="CUDA"):
        port_zones.ZoneClassifier(square, device=pref)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_zones.ZoneClassifier(square)  # the default is the card


def test_device_names():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("tpu")


@pytest.fixture(scope="module")
def i420_outputs(tmp_path_factory):
    """The JAX detector's ``i420`` run and the port's ``i420`` and ``i420d``
    runs on the same weights and frames (two calls each, so that i420d's
    chain crosses calls), with ``slice_outputs``' settings."""
    detection = dict(DETECTION, transfer_format="i420")
    jax_det = JaxDETRDetector(
        ConfigManager.from_dict({"detection": detection, "parallel": {"mesh": {"data": 1}}}),
        detr_config=JaxDETRConfig.tiny(num_classes=2),
    )
    jax_det.load_model()
    path = tmp_path_factory.mktemp("w") / "tiny.npz"
    save_weights_npz(jax_det.variables, path)
    rng = np.random.default_rng(1)
    calls = [rng.integers(0, 256, (5, 120, 160, 3), np.uint8), rng.integers(0, 256, (3, 120, 160, 3), np.uint8)]
    want = [jax_det.detect_batch(f) for f in calls]
    got = {}
    for fmt in ("i420", "i420d"):
        det = DETRDetector({f"detection.{k}": v for k, v in detection.items()}
                           | {"detection.checkpoint_path": str(path), "detection.transfer_format": fmt},
                           detr_config=DETRConfig.tiny(num_classes=2))
        got[fmt] = [det.detect_batch(f) for f in calls]
        assert det.transfer_format == fmt
    return want, got


@pytest.mark.parametrize("fmt", ["i420", "i420d", "I420"])
def test_i420_transfer_formats_run(i420_outputs, fmt):
    """Each I420 route gives the JAX detector's i420 detections at the DETR
    bars of the BGR test, and i420d the i420 route's, bit for bit, over two
    calls (the delta chain crosses chunks and calls). The value is matched
    exactly, as the JAX detector matches it: ``I420`` is no route (JAX runs
    ``bgr`` for it) and raises, as any unknown value does."""
    if fmt == "I420":
        with pytest.raises(ValueError, match="transfer_format='I420'"):
            DETRDetector({"detection.device": "cpu", "detection.transfer_format": fmt})
        with pytest.raises(ValueError, match="transfer_format='I420'"):
            check_transfer_format(fmt)
        return
    want, got = i420_outputs
    for w, g, ref in zip(want, got[fmt], got["i420"]):
        np.testing.assert_array_equal(g.valid, np.asarray(w.valid))
        np.testing.assert_allclose(g.scores, np.asarray(w.scores), atol=1e-5)
        np.testing.assert_allclose(g.boxes_xywh, np.asarray(w.boxes_xywh), atol=1e-3)
        np.testing.assert_allclose(g.foot, np.asarray(w.foot), atol=1e-3)
        for name in ("boxes_xywh", "scores", "valid", "foot"):
            np.testing.assert_array_equal(getattr(g, name), getattr(ref, name))
    assert any(np.asarray(w.valid).any() for w in want)


@pytest.mark.parametrize("fmt", ["auto", "bgr"])
def test_auto_transfer_format_races(fmt, caplog):
    """``auto`` (the shipped config.yaml's value) races bgr, i420 and i420d on
    the first batch, logs the times, keeps the fastest and runs it; ``bgr``
    runs no race."""
    det = DETRDetector({"detection.device": "cpu", "detection.transfer_format": fmt, "detection.model_size": "tiny",
                        "detection.batch_size": 2, "detection.input_height": 64, "detection.input_width": 96,
                        "detection.dtype": "float32"})
    assert det.transfer_format == fmt
    frames = np.random.default_rng(2).integers(0, 256, (3, 72, 96, 3), np.uint8)
    with caplog.at_level(logging.INFO, logger="office_person_detection_vit_torch.detection.detector"):
        batch = det.detect_batch(frames)
    assert batch.scores.shape[0] == 3
    said = [r.getMessage() for r in caplog.records if "transfer autotune" in r.getMessage()]
    if fmt == "bgr":
        assert det.transfer_format == "bgr" and det.transfer_race_ms is None and said == []
    else:
        assert det.transfer_format in TRANSFER_FORMATS
        assert set(det.transfer_race_ms) == set(TRANSFER_FORMATS)
        assert det.transfer_format == min(det.transfer_race_ms, key=det.transfer_race_ms.get)
        assert len(said) == 1 and said[0].startswith(f"transfer autotune: {det.transfer_format} (")
