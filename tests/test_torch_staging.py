"""The I420 transfer routes of the port against the JAX package: the host
staging library (``ops/staging.py`` over ``csrc/staging.cpp``, built with g++)
and its plain twins, and the device decode (``ops/preprocessing.py``).

Inputs are made with numpy from a seed. Bars: the staged bytes equal JAX's and
cv2's exactly; ``preprocess_frames_i420`` within 1e-5 of JAX's (float32, the
resize's sums in another order); the delta round trip bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.ops import preprocessing as port_pre
from office_person_detection_vit_torch.ops import staging
from office_person_detection_vit_tpu.ops import preprocessing as jax_pre
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)


def _frames(seed, n=3, h=72, w=96):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), np.uint8)


@pytest.mark.parametrize("route", ["library", "twin"])
@pytest.mark.parametrize("hw", [(72, 96), (720, 1280), (8, 6)])
def test_bgr_to_i420_bytes_equal_jax_and_cv2(route, hw):
    frames = _frames(0, 2, *hw)
    fn = staging.bgr_to_i420 if route == "library" else staging.bgr_to_i420_reference
    got = fn(frames)
    assert got.shape == (2, hw[0] * 3 // 2, hw[1]) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_pre.bgr_to_i420(frames))
    np.testing.assert_array_equal(got, staging.bgr_to_i420_reference(frames))


@pytest.mark.parametrize("route", ["library", "twin"])
@pytest.mark.parametrize("hw", [(70, 96), (72, 95)])
def test_i420_geometry_is_checked(route, hw):
    fn = staging.bgr_to_i420 if route == "library" else staging.bgr_to_i420_reference
    with pytest.raises(ValueError, match="H%4==0 and W%2==0"):
        fn(_frames(0, 1, *hw))


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No compiler: the staging library raises; nothing drops to cv2."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(staging, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(staging, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        staging.bgr_to_i420(_frames(0, 1))


@pytest.mark.parametrize("target_hw", [(96, 128), (64, 96), (48, 64)], ids=["pad", "resize_1x", "downsample"])
def test_preprocess_frames_i420_matches_jax(target_hw):
    planes = staging.bgr_to_i420(_frames(1))
    got_px, got_mask = port_pre.preprocess_frames_i420(torch.from_numpy(planes), target_hw=target_hw)
    want_px, want_mask = jax_pre.preprocess_frames_i420(jnp.asarray(planes), target_hw=target_hw)
    assert got_px.shape == (3, *target_hw, 3) and got_px.dtype == torch.float32
    np.testing.assert_allclose(got_px.numpy(), np.asarray(want_px), atol=1e-5)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_delta_round_trip_is_exact_and_equals_jax_across_two_chunks(chunk):
    """Two chained chunks: the host delta (library and twin) equals JAX's, and
    the device scan gives the frames back bit for bit."""
    planes = staging.bgr_to_i420(_frames(2, 2 * chunk))
    prev = np.zeros(planes.shape[1:], np.uint8)
    for part in (planes[:chunk], planes[chunk:]):
        deltas = staging.i420_delta_encode(part, prev)
        np.testing.assert_array_equal(deltas, staging.i420_delta_encode_reference(part, prev))
        np.testing.assert_array_equal(deltas, jax_pre.i420_delta_encode(part, prev))
        back = port_pre.reconstruct_i420_delta(torch.from_numpy(deltas), torch.from_numpy(prev))
        np.testing.assert_array_equal(back.numpy(), part)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jax_pre.reconstruct_i420_delta(jnp.asarray(deltas), jnp.asarray(prev))))
        prev = part[-1]
