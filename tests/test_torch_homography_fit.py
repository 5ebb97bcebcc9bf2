"""The port's homography fitting (``ops/homography_fit.py``) against the JAX
package's, on the CPU in float32.

- DLT on exact correspondences, all points and a masked subset: each entry
  of H within 1e-4 of the JAX H's entry, relative to that entry (both solve
  the same normalised system by SVD in float32).
- RANSAC on 200 points, 30% of them outliers 30-200 px off, the inliers
  with 0.5 px of noise: the port draws its hypotheses from a
  ``torch.Generator``, JAX from ``jax.random``, so the hypotheses differ;
  the inlier mask must equal JAX's (and the true one), the inliers'
  transfer errors within 1e-2 px of JAX's, H within 1e-4 per entry
  (relative) of JAX's.
- Below 4 correspondences both raise ``ValueError``; the hypotheses' draws
  are 4 distinct indices a row and repeat for a seed.
"""

import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.ops import homography_fit as port_fit
from office_person_detection_vit_tpu.ops import homography_fit as jax_fit
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

H = np.array([[1.2, 0.1, 50.0], [0.05, 1.5, 60.0], [1e-4, 2e-4, 1.0]])
H_RTOL = 1e-4
ERROR_ATOL_PX = 1e-2


def apply(h: np.ndarray, p: np.ndarray) -> np.ndarray:
    q = np.c_[p, np.ones(len(p))] @ h.T
    return q[:, :2] / q[:, 2:]


def assert_h_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_less(np.abs(got - want), H_RTOL * np.abs(want) + 1e-12)


@pytest.mark.parametrize("masked", [False, True])
def test_dlt_matches_jax(masked):
    rng = np.random.default_rng(1)
    src = rng.uniform([0, 0], [1280, 720], (12, 2)).astype(np.float32)
    dst = apply(H, src).astype(np.float32)
    mask = None
    if masked:  # the last 4 points are corrupted and masked out
        dst[8:] += 300.0
        mask = np.arange(12) < 8
    got = port_fit.fit_homography_dlt(src, dst, mask, device="cpu")
    want = jax_fit.fit_homography_dlt(src, dst, mask)
    assert got.dtype == torch.float32 and got.shape == (3, 3)
    assert_h_close(got.numpy(), want)
    assert_h_close(got.numpy(), H)


def ransac_load(n: int = 200, outlier_share: float = 0.3, seed: int = 2):
    rng = np.random.default_rng(seed)
    src = rng.uniform([0, 0], [1280, 720], (n, 2))
    dst = apply(H, src) + rng.normal(0, 0.5, (n, 2))
    out = rng.random(n) < outlier_share
    angle, size = rng.uniform(0, 2 * np.pi, n), rng.uniform(30, 200, n)
    dst[out] += (np.c_[np.cos(angle), np.sin(angle)] * size[:, None])[out]
    return src.astype(np.float32), dst.astype(np.float32), ~out


def test_ransac_matches_jax():
    src, dst, truth = ransac_load()
    h, inliers, errors = port_fit.fit_homography_ransac(src, dst, threshold=5.0, iterations=128, seed=0, device="cpu")
    jh, jinliers, jerrors = (np.asarray(a) for a in jax_fit.fit_homography_ransac(src, dst, 5.0, 128, 0))
    assert inliers.dtype == torch.bool and errors.shape == (200,)
    np.testing.assert_array_equal(inliers.numpy(), jinliers)
    np.testing.assert_array_equal(inliers.numpy(), truth)
    np.testing.assert_allclose(errors.numpy()[truth], jerrors[truth], rtol=0, atol=ERROR_ATOL_PX)
    assert_h_close(h.numpy(), jh)


def test_ransac_refuses_fewer_than_four_points():
    src = np.zeros((3, 2), np.float32)
    with pytest.raises(ValueError, match="need >=4"):
        jax_fit.fit_homography_ransac(src, src)
    with pytest.raises(ValueError, match="need >=4"):
        port_fit.fit_homography_ransac(src, src, device="cpu")


def test_hypotheses_are_distinct_and_seeded():
    idx = port_fit.sample_hypotheses(10, 64, seed=3)
    assert idx.shape == (64, 4) and int(idx.min()) >= 0 and int(idx.max()) < 10
    assert all(len(set(row.tolist())) == 4 for row in idx)
    assert torch.equal(idx, port_fit.sample_hypotheses(10, 64, seed=3))
    assert not torch.equal(idx, port_fit.sample_hypotheses(10, 64, seed=4))
