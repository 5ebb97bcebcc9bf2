"""The port's appearance features and attention map against the JAX package,
on the CPU in float32.

- ``roi_mean_pool``: 1e-5 absolute on the same encoder output and boxes;
  ``crop_histogram_features``: exact;
- the committed DETR-small checkpoint at 224x384 in both packages:
  ``detect_with_features`` gives the same valid detections (boxes within
  1e-3 px) and features within 1e-5; ``get_attention_map`` agrees to 1e-5,
  and it leaves ``detect_batch`` as it was;
- a failed chunk yields all-invalid detections and zero features;
- the ReID ``detr`` backend over both detectors: the same features (1e-5).
"""

from datetime import datetime
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.detection import features as port_features
from office_person_detection_vit_torch.detection.detector import DETRDetector
from office_person_detection_vit_torch.tracking.reid_feature_extractor import ReIDFeatureExtractor
from office_person_detection_vit_tpu.config.config_manager import ConfigManager
from office_person_detection_vit_tpu.detection import features as jax_features
from office_person_detection_vit_tpu.detection.detector import DETRDetector as JaxDETRDetector
from office_person_detection_vit_tpu.tracking.reid_feature_extractor import ReIDFeatureExtractor as JaxReIDFeatureExtractor
from tests.helpers.synthetic_video import render_frame
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

WEIGHTS = Path(__file__).resolve().parent.parent / "docs" / "artifacts" / "detr_small_weights.npz"
SMALL = {
    "model_size": "small", "score_mode": "sigmoid", "checkpoint_path": str(WEIGHTS), "device": "cpu",
    "dtype": "float32", "input_height": 224, "input_width": 384, "confidence_threshold": 0.2,
    "nms_threshold": 0.3, "batch_size": 1,
}


@pytest.mark.parametrize("image_wh", [(1280.0, 720.0), (1280.0, 746.7)])
def test_roi_mean_pool_matches_jax(image_wh):
    rng = np.random.default_rng(0)
    B, Q, fh, fw, C = 3, 11, 7, 12, 32
    enc = rng.normal(0, 1, (B, fh * fw, C)).astype(np.float32)
    xy = rng.uniform(-50, 1200, (B, Q, 2))
    wh = rng.uniform(0, 400, (B, Q, 2))
    boxes = np.concatenate([xy, wh], axis=-1).astype(np.float32)
    boxes[0, 0] = [2000, 2000, 10, 10]  # under no cell
    valid = rng.random((B, Q)) < 0.8
    wh_arr = np.asarray(image_wh, np.float32)
    want = jax_features.roi_mean_pool(jnp.asarray(enc), (fh, fw), jnp.asarray(boxes), jnp.asarray(valid),
                                      jnp.asarray(wh_arr))
    got = port_features.roi_mean_pool(torch.from_numpy(enc), (fh, fw), torch.from_numpy(boxes),
                                      torch.from_numpy(valid), torch.from_numpy(wh_arr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert not got.numpy()[~valid].any()


def test_crop_histogram_features_match_jax():
    rng = np.random.default_rng(1)
    frame = rng.integers(0, 256, (120, 160, 3), np.uint8)
    boxes = np.asarray([[10, 20, 40, 60], [-5, -5, 30, 30], [150, 100, 40, 40], [200, 200, 5, 5], [3.7, 8.2, 0.5, 9]],
                       np.float32)
    got = port_features.crop_histogram_features(frame, boxes)
    np.testing.assert_array_equal(got, jax_features.crop_histogram_features(frame, boxes))
    assert got.shape == (5, 256) and not got[3].any()


@pytest.fixture(scope="module")
def small_detectors():
    jax_det = JaxDETRDetector(ConfigManager.from_dict({"detection": SMALL, "parallel": {"mesh": {"data": 1}}}))
    jax_det.load_model()
    port_det = DETRDetector({f"detection.{k}": v for k, v in SMALL.items()})
    port_det.load_model()
    frame = render_frame(datetime(2025, 1, 20, 9, 0, 0), people=[(500, 350, 2), (150, 200, 0)], seed=4)
    return jax_det, port_det, frame


def test_detect_with_features_matches_jax(small_detectors):
    jax_det, port_det, frame = small_detectors
    want_dets, want = jax_det.detect_with_features(frame)
    got_dets, got = port_det.detect_with_features(frame)
    assert len(got_dets) == len(want_dets) >= 1
    for g, w in zip(got_dets, want_dets):
        np.testing.assert_allclose(g.bbox, w.bbox, atol=1e-3)
        assert g.feature is not None
    assert got.shape == want.shape == (len(want_dets), port_det.detr_config.d_model)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    assert port_det.feature_stride == 32 and port_det.last_inference_time > 0


def test_extract_features_matches_jax(small_detectors):
    jax_det, port_det, frame = small_detectors
    boxes = [(480.0, 320.0, 60.0, 170.0), (0.0, 0.0, 20.0, 20.0)]
    np.testing.assert_array_equal(port_det.extract_features(frame, boxes), jax_det.extract_features(frame, boxes))


def test_attention_map_matches_jax_and_leaves_detect_as_it_was(small_detectors):
    jax_det, port_det, frame = small_detectors
    before = port_det.detect_batch(frame[None])
    got = port_det.get_attention_map(frame)
    want = jax_det.get_attention_map(frame)
    assert got.shape == want.shape == (7, 12) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert float(got.max()) > 2.0 * float(got.mean())
    assert all(m.kept_probs is None for m in port_det.model.modules() if hasattr(m, "kept_probs"))
    after = port_det.detect_batch(frame[None])
    for name in ("boxes_xywh", "scores", "valid"):
        np.testing.assert_array_equal(getattr(after, name), getattr(before, name))


def test_failed_chunk_yields_zero_features(small_detectors, monkeypatch):
    _, port_det, frame = small_detectors
    frames = np.stack([frame, frame, frame])
    real = port_det._detect_chunk
    calls = []

    def flaky(chunk, orig_wh):
        calls.append(len(chunk))
        if len(calls) == 2:
            raise RuntimeError("poisoned chunk")
        return real(chunk, orig_wh)

    monkeypatch.setattr(port_det, "_detect_chunk", flaky)
    batch = port_det.detect_batch(frames)
    assert calls == [1, 1, 1] and port_det.last_failed_chunks == 1
    assert batch.valid[0].any() and not batch.valid[1].any() and batch.valid[2].any()
    feats = port_det._pool_features(batch)
    assert feats.shape == (3, port_det.detr_config.num_queries, port_det.detr_config.d_model)
    assert not feats[1].any() and feats[0].any()
    enc = port_det._last_encoder_output
    assert enc.shape == (3, 7 * 12, port_det.detr_config.d_model) and not enc[1].any()


def test_reid_detr_backend_matches_jax(small_detectors):
    """``tracking.reid.model_type: detr``: a requested box that overlaps one
    of the detector's own detections (IoU > 0.5) takes its encoder feature,
    one that overlaps none a crop histogram; features within 1e-5."""
    jax_det, port_det, frame = small_detectors
    dets, _ = port_det.detect_with_features(frame)
    boxes = [tuple(float(v) + 2.0 for v in d.bbox) for d in dets] + [(0.0, 600.0, 40.0, 80.0)]
    got_ex, want_ex = ReIDFeatureExtractor(detector=port_det), JaxReIDFeatureExtractor(detector=jax_det)
    for ex in (got_ex, want_ex):
        ex.load_model()
    dim = port_det.detr_config.d_model
    assert (got_ex.backend, got_ex.feature_dim) == (want_ex.backend, want_ex.feature_dim) == ("detr", dim)
    got, want = got_ex.extract_features(frame, boxes), want_ex.extract_features(frame, boxes)
    assert got.shape == (len(boxes), dim) and len(dets) >= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[-1], port_features.crop_histogram_features(frame, np.asarray(boxes[-1:]), dim)[0])
    assert not np.array_equal(got[0], port_features.crop_histogram_features(frame, np.asarray(boxes[:1]), dim)[0])
