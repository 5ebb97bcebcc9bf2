"""B.4's backward contract on the CPU, beside the JAX package.

The backward kernel pair (``kernels/attention.py::attention_backward``) runs
only on the card; its plain version
``ops.attention.attention_backward_reference`` computes the same formulas
(P = exp(S - lse), dV = P^T g, dP = g V^T, D = rowsum(g * out),
dS = P * (dP - D), dQ = scale dS K, dK = scale dS^T Q) from the forward's
output and log-sum-exp (``attention_lse``). ``KernelAttention`` runs it on
CPU tensors, and ``tests/test_torch_train_model.py::
test_kernel_attention_grads_match_jax`` holds that against ``jax.vjp`` of the
Pallas path in interpret mode (head dims 16 and 32, Lq != Lk off the 64-row
tiles, no mask, a ragged mask, an entry with every key masked). Here: its bf16
results against float64 autograd of the plain version on the same values at
2^-6 (``attention_kernel_bench.relative_errors``: each element relative to
max(1, |ref|), each tensor relative to its max |ref|; the output the backward
reads is rounded to bf16, and so are its results); the log-sum-exp at 1e-5
against ``logsumexp`` of the JAX reference's scores (log(Lk) for an entry with
every key masked, whose scores are all 0); and the wrappers on CPU tensors.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.attention_kernel_bench import relative_errors
from office_person_detection_vit_torch.kernels import attention as kernels
from office_person_detection_vit_torch.ops import attention as port_attn
from office_person_detection_vit_tpu.ops import attention as jax_attn
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

T_ = torch.from_numpy
SHAPES = [(2, 2, 37, 53), (1, 2, 100, 130), (2, 1, 67, 131)]
MASKS = ["none", "ragged", "all_masked_entry"]
BF16_TOL = 2.0**-6


def _inputs(B, H, Lq, Lk, D, mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, L, D)).astype(np.float32) for L in (Lq, Lk, Lk))
    g = rng.normal(size=(B, H, Lq, D)).astype(np.float32)
    mask = None
    if mask_kind != "none":
        mask = rng.random((B, Lk)) > 0.3
        if mask_kind == "all_masked_entry":
            mask[-1] = False
    return q, k, v, g, mask


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[2]}x{s[3]}")
@pytest.mark.parametrize("D", [16, 32, 64, 48])
def test_backward_reference_bf16_against_float64(D, shape, mask_kind):
    """bf16 inputs: the out the kernel reads (float32 forward, rounded to
    bf16), the twin's bf16 results within 2^-6 of float64 autograd of the
    plain version on the same values, each element relative to max(1, |ref|)
    and each tensor relative to its max |ref| (relative_errors)."""
    q, k, v, g, mask = _inputs(*shape, D, mask_kind, seed=1)
    tq, tk, tv, tg = (T_(a).bfloat16() for a in (q, k, v, g))
    tmask = None if mask is None else T_(mask)
    out = port_attn.attention_reference(tq.float(), tk.float(), tv.float(), tmask).bfloat16()
    lse = port_attn.attention_lse(tq, tk, tmask)
    got = port_attn.attention_backward_reference(tq, tk, tv, tmask, out, lse, tg)

    x64 = [t.double().requires_grad_(True) for t in (tq, tk, tv)]
    ref = port_attn.attention_reference(*x64, tmask)
    want = torch.autograd.grad(ref, x64, tg.double())
    assert all(a.dtype == torch.bfloat16 for a in got)
    assert max(relative_errors(got, want)) <= BF16_TOL


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("D", [16, 32, 64, 48])
def test_lse_matches_jax_logsumexp(D, mask_kind):
    B, H, Lq, Lk = 3, 2, 67, 131
    q, k, v, _, mask = _inputs(B, H, Lq, Lk, D, mask_kind, seed=2)
    got = port_attn.attention_lse(T_(q), T_(k), None if mask is None else T_(mask)).numpy()
    assert got.shape == (B, H, Lq) and got.dtype == np.float32
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k) / jnp.sqrt(jnp.asarray(D, jnp.float32))
    if mask is not None:
        scores = scores + jnp.where(jnp.asarray(mask)[:, None, None, :], 0.0, jax_attn.NEG_INF)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1))
    keyed = slice(None) if mask is None else mask.any(-1)
    np.testing.assert_allclose(got[keyed], want[keyed], atol=1e-5)
    if mask_kind == "all_masked_entry":
        np.testing.assert_allclose(got[-1], math.log(Lk), atol=1e-6)
        # exp(S - lse) is the uniform probability the JAX reference gives
        _, probs = jax_attn.attention_reference(q, k, v, jnp.asarray(mask), return_probs=True)
        np.testing.assert_allclose(np.asarray(probs)[-1], np.exp(-got[-1])[..., None] * np.ones(Lk), atol=1e-7)


def test_forward_wrappers_return_lse_on_the_cpu():
    q, k, v, _, mask = _inputs(2, 2, 37, 53, 16, "ragged", seed=4)
    tq, tk, tv, tmask = T_(q), T_(k), T_(v), T_(mask)
    for fn in (kernels.attention_flash, kernels.attention_whole_kv):
        out, lse = fn(tq, tk, tv, tmask, with_lse=True)
        assert torch.equal(out, port_attn.attention_reference(tq, tk, tv, tmask))
        assert torch.equal(lse, port_attn.attention_lse(tq, tk, tmask))
        assert torch.equal(fn(tq, tk, tv, tmask), out)


def test_backward_wrapper_raises_on_cpu_tensors():
    """The wrapper launches the pair or raises; the twin is KernelAttention's
    choice on the CPU, not the wrapper's."""
    q, k, v, g, mask = (None if a is None else T_(a) for a in _inputs(1, 2, 8, 8, 16, "none"))
    lse = port_attn.attention_lse(q, k)
    before = kernels.launch_counts["attention_backward"]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.attention_backward(q, k, v, None, q.clone(), lse, g)
    assert kernels.launch_counts["attention_backward"] == before
