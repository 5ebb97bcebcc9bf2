"""Port preprocessing, box ops and postprocess against the JAX package.

Inputs come from numpy seeds; float32. Tolerances: preprocessing 1e-5 both
at the pad-only 736x1280 geometry and at the antialiased 0.3x downsample into
224x384 (quirk C2: torch's antialiased bilinear and jax.image.resize apply the
same triangle filter; the gap measured 4.8e-7); box math 1e-4 px (pixel
coordinates up to 1280 in float32); masks exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.models import postprocess as port_post
from office_person_detection_vit_torch.ops import boxes as port_boxes
from office_person_detection_vit_torch.ops import preprocessing as port_pre
from office_person_detection_vit_tpu.models import postprocess as jax_post
from office_person_detection_vit_tpu.ops import boxes as jax_boxes
from office_person_detection_vit_tpu.ops import preprocessing as jax_pre
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)



@pytest.mark.parametrize("target_hw", [(736, 1280), (224, 384)])
def test_preprocess_matches_jax(target_hw):
    frames = np.random.default_rng(0).integers(0, 256, (2, 720, 1280, 3), np.uint8)
    got_px, got_mask = port_pre.preprocess_frames(torch.from_numpy(frames), target_hw=target_hw)
    want_px, want_mask = jax_pre.preprocess_frames(jnp.asarray(frames), target_hw=target_hw)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got_px.numpy(), np.asarray(want_px), atol=1e-5)


@pytest.mark.parametrize("src,dst", [((720, 1280), (736, 1280)), ((720, 1280), (224, 384)), ((480, 640), (96, 128))])
def test_resize_geometry_matches_jax(src, dst):
    assert port_pre.compute_resize_geometry(src, dst) == jax_pre.compute_resize_geometry(src, dst)


def _random_boxes(rng, n):
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(5, 40, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_conversions_match_jax():
    rng = np.random.default_rng(1)
    cxcywh = rng.uniform(0, 1, (3, 7, 4)).astype(np.float32)
    t, j = torch.from_numpy(cxcywh), jnp.asarray(cxcywh)
    xyxy_t, xyxy_j = port_boxes.cxcywh_to_xyxy(t), jax_boxes.cxcywh_to_xyxy(j)
    np.testing.assert_allclose(xyxy_t.numpy(), np.asarray(xyxy_j), atol=1e-6)
    xywh_t, xywh_j = port_boxes.xyxy_to_xywh(xyxy_t), jax_boxes.xyxy_to_xywh(xyxy_j)
    np.testing.assert_allclose(xywh_t.numpy(), np.asarray(xywh_j), atol=1e-6)
    np.testing.assert_allclose(
        port_boxes.foot_point_xywh(xywh_t).numpy(), np.asarray(jax_boxes.foot_point_xywh(xywh_j)), atol=1e-6
    )
    a, b = _random_boxes(rng, 9), _random_boxes(rng, 5)
    np.testing.assert_allclose(
        port_boxes.iou_matrix_xyxy(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_boxes.iou_matrix_xyxy(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6,
    )


@pytest.mark.parametrize("case", ["random", "ties", "all_invalid", "no_valid_arg"])
def test_nms_mask_matches_jax(case):
    rng = np.random.default_rng(2)
    Q = 24
    boxes = _random_boxes(rng, Q)
    scores = rng.uniform(0, 1, Q).astype(np.float32)
    valid = rng.random(Q) > 0.25
    if case == "ties":
        # Duplicated boxes with equal scores: the stable sort decides which
        # survives, so an unstable sort would keep another query.
        boxes[1::2] = boxes[0::2]
        scores[1::2] = scores[0::2]
        valid[:] = True
    elif case == "all_invalid":
        valid[:] = False
    args_t = [torch.from_numpy(boxes), torch.from_numpy(scores), 0.3]
    args_j = [jnp.asarray(boxes), jnp.asarray(scores), 0.3]
    if case != "no_valid_arg":
        args_t.append(torch.from_numpy(valid))
        args_j.append(jnp.asarray(valid))
    got = port_boxes.nms_mask(*args_t).numpy()
    want = np.asarray(jax_boxes.nms_mask(*args_j))
    np.testing.assert_array_equal(got, want)
    if case == "ties":
        assert got[0::2].all() and not got[1::2].any()


def test_nms_mask_batched_matches_per_frame():
    rng = np.random.default_rng(3)
    boxes = np.stack([_random_boxes(rng, 12) for _ in range(3)])
    scores = rng.uniform(0, 1, (3, 12)).astype(np.float32)
    valid = rng.random((3, 12)) > 0.2
    got = port_boxes.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), 0.2, torch.from_numpy(valid))
    for f in range(3):
        want = jax_boxes.nms_mask(jnp.asarray(boxes[f]), jnp.asarray(scores[f]), 0.2, jnp.asarray(valid[f]))
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want))


@pytest.mark.parametrize("score_mode", ["softmax", "sigmoid"])
@pytest.mark.parametrize("nms_iou", [None, 0.4])
def test_postprocess_matches_jax(score_mode, nms_iou):
    rng = np.random.default_rng(4)
    F, Q, C = 3, 20, 6
    logits = rng.normal(0, 3, (F, Q, C + 1)).astype(np.float32)
    logits[..., 1] += 2.0  # plenty of person argmaxes
    logits[0, 0, 1] = logits[0, 0, 2] = 9.0  # tie: argmax keeps the first (person)
    cxcywh = np.concatenate(
        [rng.uniform(0.2, 0.8, (F, Q, 2)), rng.uniform(0.05, 0.3, (F, Q, 2))], -1
    ).astype(np.float32)
    cxcywh[:, 1::2] = cxcywh[:, 0::2] + 0.01  # near-duplicates for NMS
    got = port_post.postprocess_detr(
        torch.from_numpy(logits), torch.from_numpy(cxcywh), (1280.0, 720.0), 0.3,
        person_class_id=1, score_mode=score_mode, nms_iou=nms_iou,
    )
    want = jax_post.postprocess_detr(
        jnp.asarray(logits), jnp.asarray(cxcywh), jnp.asarray([1280.0, 720.0]), 0.3,
        person_class_id=1, score_mode=score_mode, nms_iou=nms_iou,
    )
    assert got.valid[0, 0]
    assert isinstance(got.scores, np.ndarray)
    np.testing.assert_array_equal(got.valid, np.asarray(want.valid))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-6)
    np.testing.assert_allclose(got.boxes_xywh, np.asarray(want.boxes_xywh), atol=1e-4)
    np.testing.assert_allclose(got.foot, np.asarray(want.foot), atol=1e-4)
    if nms_iou is not None:
        assert 0 < got.valid.sum()


@pytest.mark.parametrize("score_mode", ["softmax", "sigmoid"])
def test_person_scores_match_jax(score_mode):
    logits = np.random.default_rng(5).normal(0, 2, (2, 5, 4)).astype(np.float32)
    got = port_post.person_scores(torch.from_numpy(logits), 1, score_mode).numpy()
    want = np.asarray(jax_post.person_scores(jnp.asarray(logits), 1, score_mode))
    np.testing.assert_allclose(got, want, atol=1e-6)
