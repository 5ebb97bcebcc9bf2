"""Multi-head attention: the plain version and the dispatch to the kernels.

Mirrors ``office_person_detection_vit_tpu/ops/attention.py``.
:func:`attention_reference` is the plain PyTorch version of
``attention_reference`` there. :func:`multi_head_attention` runs it for CPU
tensors; for CUDA tensors it runs the hand-written kernels of
``kernels/attention.py`` and nothing else: whole-KV (K1) or flash (K2) as
:func:`~office_person_detection_vit_torch.kernels.attention.use_flash` decides
(it states the rule and the H100 measurement behind it). The JAX package's ``use_pallas_attention``
choice has no counterpart here: on the card attention is always the kernel.

Under autograd (grad enabled and an input that requires grad) the card runs
:class:`KernelAttention`, the counterpart of ``_attention_pallas_diff``
(ROADMAP B.4): K1 or K2 forward, which also writes each query row's
log-sum-exp (:func:`attention_lse`), and the backward kernel pair
(``kernels/attention.py::attention_backward``, FlashAttention-2's scheme)
that recomputes the probabilities tile by tile from it. Its function is the
vector-Jacobian product of :func:`attention_reference`, which ``_attn_bwd``
returns; :func:`attention_backward_reference` is the pair's plain version
and runs in its place on the CPU.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30

#: Forwards of :class:`KernelAttention` on the card since the last
#: :func:`reset_launch_counts`: one where it launches K1 or K2 (its backward
#: is counted by the kernel wrapper, ``attention_backward``).
launch_counts = {"attention_diff": 0}


def reset_launch_counts() -> None:
    launch_counts["attention_diff"] = 0


def attention_reference(q, k, v, key_padding_mask=None, return_probs=False, scale=None):
    """q (B,H,Lq,D), k/v (B,H,Lk,D), key_padding_mask (B,Lk) bool True = valid.

    Scores in q's dtype, masked keys biased by -1e30, softmax in float32,
    probabilities cast back to q's dtype before P.V. A batch entry with every
    key masked gets uniform probabilities, i.e. mean(V) over Lk.
    ``scale``: the score scale, 1/sqrt(D) when ``None`` (a head dim padded
    with zero columns passes its true one).
    Returns (B,H,Lq,D), plus the (B,H,Lq,Lk) probabilities when
    ``return_probs``.
    """
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k)
    if scale is None:
        scores = scores / torch.sqrt(torch.tensor(d, dtype=q.dtype, device=q.device))
    else:
        scores = scores * scale
    if key_padding_mask is not None:
        bias = torch.where(key_padding_mask[:, None, None, :], 0.0, NEG_INF)
        scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    if return_probs:
        return out, probs
    return out


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _scores(q, k, key_padding_mask, scale=None):
    """float32 scaled, biased scores (B,H,Lq,Lk). A batch entry with every
    key masked scores 0 on every key (the uniform probabilities that
    :func:`attention_reference` gives it), as the kernels compute it."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s / math.sqrt(q.shape[-1]) if scale is None else s * scale
    if key_padding_mask is None:
        return s
    s = s + torch.where(key_padding_mask, 0.0, NEG_INF)[:, None, None, :]
    return torch.where(~key_padding_mask.any(-1)[:, None, None, None], 0.0, s)


def attention_lse(q, k, key_padding_mask=None, scale=None):
    """The float32 log-sum-exp of each query row's scaled, biased scores,
    (B,H,Lq): what the forward kernels write for the backward. An entry with
    every key masked gets log(Lk) (its scores are all 0)."""
    return torch.logsumexp(_scores(q, k, key_padding_mask, scale), dim=-1)


def attention_backward_reference(q, k, v, key_padding_mask, out, lse, g, scale=None):
    """(dq, dk, dv) of :func:`attention_reference` at (q, k, v) for the
    output gradient g, from the forward's output and log-sum-exp: the plain
    version of the backward kernel pair. In float32, cast to q's dtype:

        P = exp(S - lse), dV = P^T g, dP = g V^T, D_i = sum(g_i * out_i),
        dS = P * (dP - D), dQ = scale dS K, dK = scale dS^T Q,

    with scale = 1/sqrt(D) unless given. An entry with every key masked has S = 0 (uniform
    P) and keeps the true scale in dQ and dK: the plain version's autograd
    passes the score gradient through its -1e30 bias, so they are not zero.
    """
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = torch.exp(_scores(q, k, key_padding_mask, scale) - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - (gf * out.float()).sum(-1, keepdim=True))
    scale = _scale(q, scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _kernel_forward(q, k, v, key_padding_mask, with_lse=False):
    from ..kernels import attention as kernels

    fn = kernels.attention_flash if kernels.use_flash(q.shape[3], q.dtype) else kernels.attention_whole_kv
    return fn(q, k, v, key_padding_mask, with_lse=with_lse)


class KernelAttention(torch.autograd.Function):
    """K1/K2 forward with the log-sum-exp, backward kernel pair (B.4).

    The forward runs with grad off, so the kernels' wrappers launch; on a CPU
    tensor they run the plain version instead, and so does the backward
    (:func:`attention_backward_reference`). On the card the backward is the
    kernel pair and nothing else: no recompute through the plain version, no
    fallback. K1's bf16 body writes no log-sum-exp, and its wrapper raises if
    asked for one (``use_flash`` sends every bf16 call to K2). Under
    ``torch.utils.checkpoint`` the forward runs again in the recompute, so a
    layer launches its kernel twice, as ``jax.checkpoint`` does.
    """

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask):
        out, lse = _kernel_forward(q, k, v, key_padding_mask, with_lse=True)
        ctx.save_for_backward(q, k, v, key_padding_mask, out, lse)
        if q.device.type == "cuda":
            launch_counts["attention_diff"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_padding_mask, out, lse = ctx.saved_tensors
        g = g.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = attention_backward_reference(q, k, v, key_padding_mask, out, lse, g)
        else:
            from ..kernels import attention as kernels

            dq, dk, dv = kernels.attention_backward(q, k, v, key_padding_mask, out, lse, g)
        return dq, dk, dv, None


@torch.library.custom_op("office_person_detection_vit_torch::attention", mutates_args=())
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 key_padding_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The forward as one operator, ``torch.ops.office_person_detection_vit_torch.attention``:
    K1 or K2 on a CUDA tensor (through their wrappers, which count the
    launches), the plain version on a CPU one. ``torch.export`` records the
    operator itself (its fake below gives the shape), so an exported detect
    program calls the hand-written kernel when it runs on the card; the
    loader imports this module, which registers it."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_padding_mask)
    return _kernel_forward(q, k, v, key_padding_mask)


@attention_op.register_fake
def _(q, k, v, key_padding_mask=None):
    return torch.empty_like(q)


def multi_head_attention(q, k, v, key_padding_mask=None):
    """Plain version on the CPU; on the card K1 or K2, through
    :class:`KernelAttention` when a gradient is wanted (see module doc).
    While ``torch.export`` traces, every call is :func:`attention_op`, which
    runs the same two when the exported program runs."""
    if torch.compiler.is_exporting():
        return attention_op(q, k, v, key_padding_mask)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_padding_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return KernelAttention.apply(q, k, v, key_padding_mask)
    return _kernel_forward(q, k, v, key_padding_mask)

