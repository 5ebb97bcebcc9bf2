"""One DETR training step of the port against the JAX package's, on the CPU:
the slice as a whole.

The tiny tier with the encoder objectness head (so every loss of
``_loss_fn`` runs: the set loss, the aux loss of the first decoder layer and
the encoder objectness), float32, dropout 0, no augmentation, the same weights
and batch (numpy from a seed). In order:

1. both matchers pick the same queries for every decoder layer of every
   image (the port's batched auction over the port's outputs, JAX's per
   layer over JAX's; the costs agree to the forward's rounding and the bids
   move in steps of 1e-3, so a difference would be a finding);
2. the loss metrics agree within 1e-4 relative;
3. every parameter's gradient within 1e-4 of the leaf's max |grad| (the
   forward's float32 rounding carried through the backward of 4 layers);
4. the port's step applies the update: every parameter with a gradient moves.

The optimizer is held against optax alone in tests/test_torch_training.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.models import detr as port_detr
from office_person_detection_vit_torch.models.weights import flat_leaves_from_state_dict, state_dict_from_flax
from office_person_detection_vit_torch.training import criterion as port_crit
from office_person_detection_vit_torch.training import train_step as port_step
from office_person_detection_vit_tpu.models import detr as jax_detr
from office_person_detection_vit_tpu.training import criterion as jax_crit
from office_person_detection_vit_tpu.training import matcher as jax_match
from office_person_detection_vit_tpu.training import train_step as jax_step
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

H, W, B, T, C = 64, 96, 2, 4, 5


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_detr.DETRConfig.tiny(num_classes=C, enc_objectness=True)
    jmodel, variables = jax_detr.init_detr(jcfg, jax.random.PRNGKey(1), input_hw=(H, W))
    fields = {f.name for f in dataclasses.fields(port_detr.DETRConfig)}
    pcfg = port_detr.DETRConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    model = port_detr.DETR(pcfg)
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables), pcfg))

    rng = np.random.default_rng(11)
    mask = np.ones((B, H, W), bool)
    mask[1, :, 80:] = False  # a letterboxed image
    batch = {
        "pixels": rng.normal(size=(B, H, W, 3)).astype(np.float32),
        "pixel_mask": mask,
        "labels": rng.integers(0, C, (B, T)).astype(np.int32),
        "boxes": np.concatenate([rng.uniform(0.2, 0.8, (B, T, 2)), rng.uniform(0.05, 0.3, (B, T, 2))],
                                -1).astype(np.float32),
        "valid": np.array([[True, True, True, False], [True, False, False, False]]),
    }
    return jmodel, variables, model, batch


def test_both_matchers_pick_the_same_queries(setup):
    jmodel, variables, model, batch = setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = jmodel.apply(variables, jb["pixels"], jb["pixel_mask"], return_aux=True)
    layers = [(out["aux_logits"][i], out["aux_boxes"][i]) for i in range(out["aux_logits"].shape[0])]
    layers.append((out["logits"], out["boxes"]))
    want = np.stack([np.asarray(jax_match.batch_hungarian_match(lg, bx, jb["labels"], jb["boxes"], jb["valid"],
                                                                200, "ce", 0.25, 2.0)) for lg, bx in layers])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        pout = model.train()(tb["pixels"], tb["pixel_mask"], return_aux=True)
    logits = torch.cat([pout["aux_logits"], pout["logits"][None]])
    boxes = torch.cat([pout["aux_boxes"], pout["boxes"][None]])
    L = logits.shape[0]
    got = port_crit.match(logits, boxes, tb["labels"].expand(L, B, T), tb["boxes"].expand(L, B, T, 4),
                          tb["valid"].expand(L, B, T))
    np.testing.assert_array_equal(got.numpy(), want)


def test_loss_and_gradients_match_jax(setup):
    jmodel, variables, model, batch = setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    crit = jax_crit.CriterionConfig(num_classes=C)

    def loss(params):
        return jax_step._loss_fn(params, jmodel, crit, jb["pixels"], jb["pixel_mask"], jb["labels"],
                                 jb["boxes"], jb["valid"], jax.random.PRNGKey(0), True)

    (_, jmet), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    m = port_detr.DETR(model.config)
    m.load_state_dict(model.state_dict())
    m.train()
    total, met = port_step.loss_fn(m, port_crit.CriterionConfig(num_classes=C), tb, None, True)
    total.backward()
    assert set(met) == set(jmet) >= {"loss", "loss_aux", "loss_enc_obj", "loss_class", "loss_bbox", "loss_giou"}
    for key in met:
        np.testing.assert_allclose(met[key].item(), float(jmet[key]), rtol=1e-4, err_msg=key)

    keys, params = port_step.ordered_parameters(m)
    got = flat_leaves_from_state_dict(dict(zip(keys, port_step.gradients(params))), m.config)
    wants = [np.asarray(w) for w in jax.tree_util.tree_leaves(jgrads)]
    top = max(float(np.abs(w).max()) for w in wants)
    first = "decoder.layer_0.self_attn."
    for key, g, want in zip(keys, got, wants):
        if key.endswith("k_proj.bias") or key.startswith((first + "q_proj.", first + "k_proj.",
                                                          first + "v_proj.weight")):
            # Exactly zero, so both sides hold rounding noise: a key bias adds
            # the same q.b to every score of a query, which the softmax
            # cancels; the first decoder layer's self-attention reads tgt = 0,
            # so its values are all the v bias and its output does not depend
            # on the probabilities.
            assert max(np.abs(g).max(), np.abs(want).max()) <= 1e-4 * top, key
            continue
        assert np.abs(g - want).max() <= 1e-4 * float(np.abs(want).max()), key


def test_the_port_step_updates_every_parameter(setup):
    _, _, model, batch = setup
    m = port_detr.DETR(model.config)
    m.load_state_dict(model.state_dict())
    tx = port_step.make_optimizer(1e-3, 1e-4)
    state = port_step.TrainState.create(m, tx, ema=True)
    before = [p.detach().clone() for p in state.params]
    step = port_step.make_train_step(m, tx, ema_decay=0.9)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, metrics = step(state, tb, torch.Generator().manual_seed(0))
    assert state.step == 1 and state.opt_state.count == 1
    assert all(np.isfinite(v.item()) for v in metrics.values())
    for key, a, p in zip(state.keys, before, state.params):
        # Every leaf with a gradient moves. The first decoder layer's
        # self-attention reads tgt = 0: its values are all the v bias, so its
        # q, k and v projections get no gradient, and weight decay alone
        # (lr x 1e-4 of the value) may be under float32's resolution.
        assert not torch.equal(a, p) or not p.grad.any(), key
    for a, e, p in zip(before, state.ema_params, state.params):  # the EMA trails each moved leaf
        assert torch.equal(a, p) or not torch.equal(e, p)
