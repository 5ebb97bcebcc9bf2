"""The port's training modules against the JAX package's, on the CPU: the
auction matcher, the set criterion, the optimizer, the augmentation and the
loader.

Inputs are numpy from a seed, in float32. Tolerances, each with its reason:

- the auction matcher: the identical index vector (the same float32
  arithmetic and argmax tie rule), for the fixed-trip form and the batched
  form that stops early, on 24 seeded benefit matrices (T = Q, T < Q, ties,
  zero-cost padded rows); ``matching_cost`` within 1e-6 (sums in another
  order);
- ``detr_loss`` (``ce`` and ``focal``): total and components within 1e-5
  relative, gradients with respect to logits and boxes within 1e-6;
  ``encoder_objectness_loss`` within 1e-6;
- the optimizer alone, fed identical gradients: params and EMA within 1e-6 of
  ``make_optimizer`` + ``apply_update`` after 3 updates (float32 rounding of
  updates of 1e-2 on values near 1), with each schedule, accumulation and EMA;
- augmentation with flip probability 1 and no photometric range: equal; the
  loader: the same batches for two epochs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.training import augment as port_aug
from office_person_detection_vit_torch.training import criterion as port_crit
from office_person_detection_vit_torch.training import data as port_data
from office_person_detection_vit_torch.training import matcher as port_match
from office_person_detection_vit_torch.training import train_step as port_step
from office_person_detection_vit_tpu.training import augment as jax_aug
from office_person_detection_vit_tpu.training import criterion as jax_crit
from office_person_detection_vit_tpu.training import data as jax_data
from office_person_detection_vit_tpu.training import matcher as jax_match
from office_person_detection_vit_tpu.training import train_step as jax_step
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

T_ = torch.from_numpy


# --------------------------------------------------------------- matcher
def _benefit(seed):
    rng = np.random.default_rng(seed)
    T = int(rng.integers(1, 11))
    Q = T if seed % 4 == 0 else int(rng.integers(T, 16))  # T = Q, and T < Q
    b = rng.normal(size=(T, Q)).astype(np.float32)
    if seed % 3 == 0:
        b = np.round(b, 1)  # ties
    if seed % 5 == 1:
        b[(T + 1) // 2:] = -0.0  # zero-cost padded rows, as hungarian_match makes them
    return b


@pytest.mark.parametrize("seed", range(24))
def test_auction_matches_jax(seed):
    b = _benefit(seed)
    want = np.asarray(jax_match.auction_assignment(jnp.asarray(b)))
    np.testing.assert_array_equal(port_match.auction_assignment(T_(b), check_every=0).numpy(), want)
    np.testing.assert_array_equal(port_match.auction_assignment(T_(b)).numpy(), want)
    assert sorted(set(want.tolist())) == sorted(want.tolist())  # a matching


def test_auction_patch_up_matches_jax():
    """With too few trips the leftover rows are patched greedily, as in JAX."""
    for seed in range(6):
        b = _benefit(seed)
        want = np.asarray(jax_match.auction_assignment(jnp.asarray(b), num_iters=2))
        np.testing.assert_array_equal(port_match.auction_assignment(T_(b), num_iters=2, check_every=0).numpy(), want)


@pytest.fixture(scope="module")
def stacked_problems():
    """30 problems of one shape, with each one's fixed-trip answer (port and
    JAX, which agree)."""
    rng = np.random.default_rng(1)
    b = rng.normal(size=(30, 7, 12)).astype(np.float32)
    b[::4, 4:] = -0.0
    fixed = np.stack([port_match.auction_assignment(T_(x), check_every=0).numpy() for x in b])
    jitted = jax.jit(jax.vmap(jax_match.auction_assignment))
    np.testing.assert_array_equal(fixed, np.asarray(jitted(jnp.asarray(b))))
    return b, fixed


@pytest.mark.parametrize("check_every", [1, 8, 13])
def test_batched_early_stop_equals_fixed_trips(stacked_problems, check_every):
    """Independent problems stacked in one call, stopped once all rows are
    assigned, give each problem's fixed-trip answer bit for bit."""
    b, fixed = stacked_problems
    np.testing.assert_array_equal(port_match.auction_assignment(T_(b), check_every=check_every).numpy(), fixed)


def _predictions(seed, B=2, Q=10, C=5, T=4):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, Q, C + 1)).astype(np.float32)
    boxes = (1 / (1 + np.exp(-rng.normal(size=(B, Q, 4))))).astype(np.float32)
    labels = rng.integers(0, C, (B, T)).astype(np.int32)
    tboxes = np.concatenate([rng.uniform(0.2, 0.8, (B, T, 2)), rng.uniform(0.05, 0.3, (B, T, 2))],
                            -1).astype(np.float32)
    valid = np.zeros((B, T), bool)
    valid[0, :3] = True
    valid[1, :1] = True
    return logits, boxes, labels, tboxes, valid


@pytest.mark.parametrize("class_cost", ["ce", "focal"])
def test_matching_cost_and_match_match_jax(class_cost):
    logits, boxes, labels, tboxes, valid = _predictions(2)
    got = port_match.matching_cost(T_(logits[0]), T_(boxes[0]), T_(labels[0]), T_(tboxes[0]), class_cost=class_cost)
    want = jax_match.matching_cost(*(jnp.asarray(a) for a in (logits[0], boxes[0], labels[0], tboxes[0])),
                                   class_cost=class_cost)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    got = port_match.batch_hungarian_match(*(T_(a) for a in (logits, boxes, labels, tboxes, valid)),
                                           class_cost=class_cost)
    want = jax_match.batch_hungarian_match(*(jnp.asarray(a) for a in (logits, boxes, labels, tboxes, valid)),
                                           200, class_cost, 0.25, 2.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_more_targets_than_queries_raises():
    logits, boxes, labels, tboxes, valid = _predictions(3, Q=3, T=4)
    with pytest.raises(ValueError, match="T=4 > Q=3"):
        port_match.hungarian_match(*(T_(a[0]) for a in (logits, boxes, labels, tboxes, valid)))


# ------------------------------------------------------------- criterion
@pytest.mark.parametrize("class_loss", ["ce", "focal"])
def test_detr_loss_and_grads_match_jax(class_loss):
    logits, boxes, labels, tboxes, valid = _predictions(4)
    jcfg = jax_crit.CriterionConfig(num_classes=5, class_loss=class_loss)
    pcfg = port_crit.CriterionConfig(num_classes=5, class_loss=class_loss)

    def f(lg, bx):
        return jax_crit.detr_loss(lg, bx, jnp.asarray(labels), jnp.asarray(tboxes), jnp.asarray(valid), jcfg)

    (jtotal, jmet), (glog, gbox) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(boxes))
    tl, tb = T_(logits).requires_grad_(True), T_(boxes).requires_grad_(True)
    total, met = port_crit.detr_loss(tl, tb, T_(labels), T_(tboxes), T_(valid), pcfg)
    total.backward()
    assert set(met) == set(jmet)
    for key in met:
        np.testing.assert_allclose(met[key].item(), float(jmet[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(glog), atol=1e-6)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gbox), atol=1e-6)


def test_encoder_objectness_loss_matches_jax():
    rng = np.random.default_rng(5)
    _, _, _, tboxes, valid = _predictions(5)
    enc = rng.normal(size=(2, 4 * 6)).astype(np.float32)
    fmask = np.ones((2, 4, 6), bool)
    fmask[1, 3:, :] = False  # letterbox rows
    fmask[1, :, 5:] = False
    got = port_crit.encoder_objectness_loss(T_(enc), T_(fmask), T_(tboxes), T_(valid))
    want = jax_crit.encoder_objectness_loss(*(jnp.asarray(a) for a in (enc, fmask, tboxes, valid)))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6)


def test_pack_targets_matches_jax():
    boxes = [np.full((3, 4), 0.5, np.float32), np.zeros((0, 4), np.float32), np.ones((5, 4), np.float32)]
    labels = [[1, 2, 3], [], [1] * 5]
    got = port_crit.pack_targets(boxes, labels, 4)
    want = jax_crit.pack_targets(boxes, labels, 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------- optimizer
OPT_CASES = {
    "constant": dict(schedule=None),
    "cosine": dict(schedule="cosine", total_steps=6, warmup_steps=2),
    "step": dict(schedule="step", drop_at=2, warmup_steps=1),
    "accum2": dict(schedule=None, accum_steps=2),
    "ema": dict(schedule=None, ema=0.9),
}


#: A params tree with a backbone group and a main group (optax labels the
#: groups by the path key "backbone"); the update is per element, so a small
#: tree tests what a DETR's 148 leaves would.
OPT_SHAPES = {"backbone": {"bn": {"scale": (4,)}, "conv": {"kernel": (3, 3, 2, 4)}},
              "head": {"bias": (5,), "kernel": (4, 5)}}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_optax(case):
    kw = dict(OPT_CASES[case])
    ema = kw.pop("ema", None)
    accum = kw.get("accum_steps", 1)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(lambda s: rng.normal(size=s).astype(np.float32), OPT_SHAPES,
                                    is_leaf=lambda x: isinstance(x, tuple))
    paths, treedef = jax.tree_util.tree_flatten_with_path(params)
    keys = [".".join(p.key for p in path) for path, _ in paths]
    opt_kw = dict(learning_rate=1e-2, backbone_lr=1e-3, **kw)
    jtx = jax_step.make_optimizer(**opt_kw)
    jstate = jax_step.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), jtx, ema=ema is not None)
    ptx = port_step.make_optimizer(**opt_kw)
    pparams = [torch.from_numpy(leaf.copy()) for _, leaf in paths]
    pstate = port_step.TrainState(0, None, keys, pparams, ptx.init(pparams),
                                  [p.clone() for p in pparams] if ema is not None else None)
    for i in range(3 * accum):
        grads = [rng.normal(0, 0.05 if i % 2 else 1.0, p.shape).astype(np.float32) for p in pparams]
        jstate = jax_step.apply_update(jstate, jax.tree_util.tree_unflatten(treedef, grads), jtx, ema)
        port_step.apply_update(pstate, [torch.from_numpy(g) for g in grads], ptx, ema)
    assert pstate.step == int(jstate.step)
    for got, want, init in zip(pstate.params, jax.tree_util.tree_leaves(jstate.params), (l for _, l in paths)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        assert np.abs(got.numpy() - init).min() > 1e-6  # every element moved, both groups
    if ema is not None:
        for got, want in zip(pstate.ema_params, jax.tree_util.tree_leaves(jstate.ema_params)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(schedule="cosine", total_steps=10, warmup_steps=3),
                                dict(schedule="cosine", total_steps=10), dict(schedule="step", drop_at=4),
                                dict(schedule="step", drop_at=5, warmup_steps=2), dict(warmup_steps=3)])
def test_schedule_matches_optax(kw):
    got = port_step.make_schedule(0.1, **kw)
    want = jax_step.make_schedule(0.1, **kw)
    for n in range(12):
        np.testing.assert_allclose(got(n), float(want(n) if callable(want) else want), rtol=1e-6, atol=1e-9)


# ------------------------------------------------------- augment and data
def test_augment_flip_matches_jax():
    rng = np.random.default_rng(6)
    pixels = rng.normal(size=(3, 8, 12, 3)).astype(np.float32)
    boxes = rng.uniform(0, 1, (3, 4, 4)).astype(np.float32)
    batch = {"pixels": pixels, "boxes": boxes, "pixel_mask": np.ones((3, 8, 12), bool)}
    for content_w in (None, 9):
        cfg = dict(hflip_prob=1.0, brightness=0.0, contrast=0.0, content_w=content_w)
        want = jax_aug.augment_batch(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()},
                                     jax_aug.AugmentConfig(**cfg))
        got = port_aug.augment_batch(torch.Generator().manual_seed(0), {k: T_(v) for k, v in batch.items()},
                                     port_aug.AugmentConfig(**cfg))
        for key in batch:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert port_aug.content_width((768, 1344)) == jax_aug.content_width((768, 1344))
    assert port_aug.content_width((96, 128)) == jax_aug.content_width((96, 128))


def test_augment_photometric_ranges():
    """out = x * (1 + c) + b per sample: x = 0 reads b, x = 1 reads 1 + c + b;
    each within its range, and varying."""
    pixels = torch.zeros(400, 4, 2, 3)
    pixels[:, 2:] = 1.0
    batch = {"pixels": pixels, "boxes": torch.full((400, 1, 4), 0.5)}
    cfg = port_aug.AugmentConfig(hflip_prob=0.0, brightness=0.2, contrast=0.3)
    out = port_aug.augment_batch(torch.Generator().manual_seed(1), batch, cfg)["pixels"]
    b = out[:, 0, 0, 0]
    c = out[:, 2, 0, 0] - 1.0 - b
    assert b.abs().max() <= 0.2 and c.abs().max() <= 0.3 + 1e-6
    assert b.std() > 0.05 and c.std() > 0.05
    assert (out[:, :2] == b[:, None, None, None]).all()


def test_loader_gives_the_jax_batches(tmp_path):
    import cv2

    rng = np.random.default_rng(8)
    samples = []
    for i in range(7):
        p = tmp_path / f"{i}.png"
        cv2.imwrite(str(p), rng.integers(0, 255, (18, 32, 3), np.uint8))
        n = int(rng.integers(0, 4))
        samples.append((p, rng.uniform(0, 1, (n, 4)).astype(np.float32), [1] * n))
    samples.append((tmp_path / "missing.png", np.zeros((0, 4), np.float32), []))
    kw = dict(capacity=2, resize_wh=(16, 9), seed=3, depth=2)
    port = port_data.COCOBatchLoader(samples, 3, **kw)
    ref = jax_data.COCOBatchLoader(samples, 3, **kw)
    assert port.steps_per_epoch == ref.steps_per_epoch == 2
    for epoch in range(2):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
