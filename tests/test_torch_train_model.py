"""B.4 and the training model of the port against the JAX package, on the CPU.

- B.4, ``ops.attention.KernelAttention`` (the custom VJP
  ``_attention_pallas_diff``), with the plain forward and the backward
  kernel pair's plain version in place of the kernels (CPU tensors): output
  and dq/dk/dv within 1e-5 of ``jax.vjp`` through
  ``multi_head_attention(..., use_pallas=True, interpret=True)`` (sums in
  another order), at head dims 16 and 32, Lq != Lk off the 64-row tiles, no
  mask, a ragged mask and an entry with every key masked. ``multi_head_attention`` takes it whenever grad is on and
  an input requires grad; K3 still refuses under grad.
- The model (tiny tier, float32): ``return_aux`` logits and boxes at the DETR
  bar (logits atol 2e-3 / rtol 1e-3, boxes 1e-3); bf16 compute from float32
  parameters; the trainable tensors are the Flax leaves one for one; dropout
  is seeded, only in train(), and replayed under remat.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.kernels import build
from office_person_detection_vit_torch.models import detr as port_detr
from office_person_detection_vit_torch.models.resnet import Bottleneck
from office_person_detection_vit_torch.models.weights import flat_leaves_from_state_dict, state_dict_from_flax
from office_person_detection_vit_torch.ops import attention as port_attn
from office_person_detection_vit_torch.ops.fused_bottleneck import fold_identity_bottleneck
from office_person_detection_vit_torch.training import train_step as port_step
from office_person_detection_vit_tpu.models import detr as jax_detr
from office_person_detection_vit_tpu.ops import attention as jax_attn
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

T_ = torch.from_numpy


# ------------------------------------------------------------------- B.4
#: (B, H, Lq, Lk, D), and the key mask: None, the fraction of keys masked,
#: or "all_masked_entry" (0.3 masked, the last entry's keys all masked).
#: Head dims 16 and 32; Lq != Lk, off the 64-row tiles. Then one case each
#: at 192 and 256, the head dims of the Hopper bodies above 128.
_FIRST_B4_CASES = [((2, 2, 37, 53, 16), 0.3), ((1, 2, 100, 130, 32), None)]
B4_GRAD_CASES = _FIRST_B4_CASES + [
    case for case in (((B, H, Lq, Lk, D), m) for D in (16, 32)
                      for B, H, Lq, Lk in ((2, 2, 37, 53), (1, 2, 100, 130), (2, 1, 67, 131))
                      for m in (None, 0.3, "all_masked_entry"))
    if case not in _FIRST_B4_CASES
] + [((2, 1, 33, 67, 192), 0.3), ((2, 1, 67, 33, 256), "all_masked_entry")]


@pytest.mark.parametrize("shape,mask_frac", B4_GRAD_CASES)
def test_kernel_attention_grads_match_jax(shape, mask_frac):
    """KernelAttention on CPU tensors: the forward's plain version with its
    log-sum-exp (attention_lse), and the backward's plain version
    attention_backward_reference, against jax.vjp. An entry with every key
    masked has uniform probabilities, and its dq and dk are not zero: the
    -1e30 bias passes the score gradient through."""
    B, H, Lq, Lk, D = shape
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(B, H, L, D)).astype(np.float32) for L in (Lq, Lk, Lk))
    frac = 0.3 if mask_frac == "all_masked_entry" else mask_frac
    mask = None if frac is None else rng.random((B, Lk)) > frac
    if mask_frac == "all_masked_entry":
        mask[-1] = False
    g = rng.normal(size=(B, H, Lq, D)).astype(np.float32)

    tq, tk, tv = (T_(a).requires_grad_(True) for a in (q, k, v))
    out = port_attn.KernelAttention.apply(tq, tk, tv, None if mask is None else T_(mask))
    out.backward(T_(g))

    jm = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        return jax_attn.multi_head_attention(q, k, v, jm, use_pallas=True, interpret=True)

    want, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    if mask_frac == "all_masked_entry":
        # the Pallas forward in interpret mode averages over its padded keys
        # there too; the plain version's uniform average is the contract
        want = want.at[-1].set(jax_attn.attention_reference(q[-1:], k[-1:], v[-1:], jnp.asarray(mask[-1:]))[0])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    if mask_frac == "all_masked_entry":
        assert all(t.grad[-1].abs().max().item() > 1e-3 for t in (tq, tk))


def test_multi_head_attention_routes_grad_through_b4(monkeypatch):
    """Off the CPU, a call with grad on and an input that requires grad goes
    through KernelAttention (K1/K2 forward); without grad, straight to the
    kernels. A meta tensor stands in for a CUDA one, its kernel replaced by
    the plain version."""
    calls = []

    def fake_kernel(q, k, v, mask, with_lse=False):
        calls.append(torch.is_grad_enabled())
        out = port_attn.attention_reference(q, k, v, mask)
        return (out, port_attn.attention_lse(q, k, mask)) if with_lse else out

    monkeypatch.setattr(port_attn, "_kernel_forward", fake_kernel)
    q = torch.empty(1, 2, 8, 16, device="meta", requires_grad=True)
    out = port_attn.multi_head_attention(q, q, q)
    assert type(out.grad_fn).__name__ == "KernelAttentionBackward" and calls == [False]
    with torch.no_grad():
        assert port_attn.multi_head_attention(q, q, q).grad_fn is None
    assert port_attn.multi_head_attention(q.detach(), q.detach(), q.detach()).grad_fn is None
    assert calls == [False, False, True]  # the last with grad on, nothing to differentiate


def test_k3_still_refuses_grad_and_its_fold_gives_none():
    """K3 has no VJP in the JAX package and none in the port: it refuses
    under grad, naming B.4. FrozenBN's scale and bias are parameters now;
    the fold of a block hands K3 tensors that do not require grad."""
    block = Bottleneck(32, 8, 32)
    assert block.bn0.scale.requires_grad
    ws = fold_identity_bottleneck(block)
    assert not any(w.requires_grad for w in ws)
    x = torch.zeros(1, 4, 4, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="B.4.*fused bottleneck is not"):
        build.refuse_autograd("fused_bottleneck", x, *ws)


# ----------------------------------------------------------------- model
@pytest.fixture(scope="module")
def tiny_jax():
    jcfg = jax_detr.DETRConfig.tiny(num_classes=5)
    return jax_detr.init_detr(jcfg, jax.random.PRNGKey(0), input_hw=(64, 96))


@pytest.fixture
def tiny(tiny_jax):
    """(JAX model, its variables, the port model carrying them)."""
    jmodel, variables = tiny_jax
    fields = {f.name for f in dataclasses.fields(port_detr.DETRConfig)}
    pcfg = port_detr.DETRConfig(**{k: v for k, v in dataclasses.asdict(jmodel.config).items() if k in fields})
    model = port_detr.DETR(pcfg)
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables), pcfg))
    return jmodel, variables, model


def _images(seed=0, B=2, H=64, W=96):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    mask = np.ones((B, H, W), bool)
    mask[1, :, 80:] = False
    return img, mask


def test_return_aux_matches_jax(tiny):
    jmodel, variables, model = tiny
    img, mask = _images()
    want = jmodel.apply(variables, jnp.asarray(img), jnp.asarray(mask), return_aux=True)
    with torch.no_grad():
        got = model.eval()(T_(img), T_(mask), return_aux=True)
    assert got["aux_logits"].shape == (1, 2, 10, 6) and got["aux_boxes"].shape == (1, 2, 10, 4)
    for key in ("logits", "aux_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-3, rtol=1e-3)
    for key in ("boxes", "aux_boxes"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-3)


def test_bf16_compute_from_float32_params(tiny):
    """float32 parameters with bf16 compute give exactly the bf16 numbers of
    weights rounded to bf16 once (the detector's model), so the detect path
    does not move; and they stay near the float32 forward. Bar against the
    float32 forward: logits 0.15 absolute and boxes 0.03: bf16 keeps 8
    significant bits (2^-8 relative a rounding), and the tiny model's logits
    (|x| up to about 4) pass about 20 roundings on 2+2 layers; the boxes come
    through a sigmoid, which flattens the error."""
    _, _, model = tiny
    img, mask = _images()
    cfg_bf16 = dataclasses.replace(model.config, dtype="bfloat16")
    master = port_detr.DETR(cfg_bf16)
    master.load_state_dict(model.state_dict())
    rounded = port_detr.DETR(cfg_bf16)
    rounded.load_state_dict(model.state_dict())
    rounded.to(torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in master.parameters())
    with torch.no_grad():
        got = master.eval()(T_(img), T_(mask))
        once = rounded.eval()(T_(img), T_(mask))
        ref = model.eval()(T_(img), T_(mask))
    for key in ("logits", "boxes"):
        assert torch.equal(got[key], once[key]), key
    assert (got["logits"] - ref["logits"]).abs().max().item() <= 0.15
    assert (got["boxes"] - ref["boxes"]).abs().max().item() <= 0.03


@pytest.mark.parametrize("tier", ["tiny", "small"])
def test_trainable_tensors_are_the_jax_leaves(tier):
    """One trainable tensor per Flax param leaf, in flattening order, with the
    leaf's shape (conv kernels HWIO <- OIHW, dense (in, out) <- (out, in));
    FrozenBN's scale and bias among them."""
    jcfg = getattr(jax_detr.DETRConfig, tier)()
    jmodel = jax_detr.DETR(jcfg)
    variables = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)),
                               jnp.ones((1, 64, 96), bool))
    leaves = jax.tree_util.tree_leaves(variables["params"])
    model = port_detr.DETR(getattr(port_detr.DETRConfig, tier)())
    keys, params = port_step.ordered_parameters(model)
    assert len(params) == len(leaves) == len(list(model.parameters()))
    assert all(p.requires_grad for p in params)
    assert sum("bn" in k for k in keys) > 0
    flat = flat_leaves_from_state_dict(dict(zip(keys, params)), model.config)
    assert [a.shape for a in flat] == [np.shape(leaf) for leaf in leaves]


def test_dropout_is_seeded_and_only_in_train_mode(tiny):
    _, _, model = tiny
    cfg = dataclasses.replace(model.config, dropout=0.1)
    drop = port_detr.DETR(cfg)
    drop.load_state_dict(model.state_dict())
    img, mask = _images()
    runs = []
    for seed in (7, 7, 8):
        with torch.no_grad():
            runs.append(drop.train()(T_(img), T_(mask), generator=torch.Generator().manual_seed(seed))["logits"])
    with torch.no_grad():
        ev = drop.eval()(T_(img), T_(mask))["logits"]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2]) and not torch.equal(runs[0], ev)
    with pytest.raises(ValueError, match="generator"):
        drop.train()(T_(img), T_(mask))


def test_remat_replays_the_dropout_masks(tiny):
    """With remat the layers rerun in the backward from the same seeds: the
    gradients equal those without remat."""
    _, _, model = tiny
    img, mask = _images()
    grads = []
    for remat in (False, True):
        m = port_detr.DETR(dataclasses.replace(model.config, dropout=0.1, remat=remat))
        m.load_state_dict(model.state_dict())
        out = m.train()(T_(img), T_(mask), return_aux=True, generator=torch.Generator().manual_seed(3))
        (out["logits"].square().sum() + out["aux_boxes"].sum()).backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


