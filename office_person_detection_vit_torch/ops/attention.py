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
(ROADMAP B.4): K1 or K2 forward, and a backward that recomputes
:func:`attention_reference` from the saved inputs and returns its
vector-Jacobian product, as ``_attn_bwd`` does. The JAX package has no
backward kernel, so neither has the port.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

#: Forwards of :class:`KernelAttention` on the card since the last
#: :func:`reset_launch_counts`: one where it launches K1 or K2.
launch_counts = {"attention_diff": 0}


def reset_launch_counts() -> None:
    launch_counts["attention_diff"] = 0


def attention_reference(q, k, v, key_padding_mask=None, return_probs=False):
    """q (B,H,Lq,D), k/v (B,H,Lk,D), key_padding_mask (B,Lk) bool True = valid.

    Scores in q's dtype, masked keys biased by -1e30, softmax in float32,
    probabilities cast back to q's dtype before P.V. A batch entry with every
    key masked gets uniform probabilities, i.e. mean(V) over Lk.
    Returns (B,H,Lq,D), plus the (B,H,Lq,Lk) probabilities when
    ``return_probs``.
    """
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / torch.sqrt(
        torch.tensor(d, dtype=q.dtype, device=q.device)
    )
    if key_padding_mask is not None:
        bias = torch.where(key_padding_mask[:, None, None, :], 0.0, NEG_INF)
        scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    if return_probs:
        return out, probs
    return out


def _kernel_forward(q, k, v, key_padding_mask):
    from ..kernels import attention as kernels

    if kernels.use_flash(k.shape[2], q.shape[3], q.dtype):
        return kernels.attention_flash(q, k, v, key_padding_mask)
    return kernels.attention_whole_kv(q, k, v, key_padding_mask)


class KernelAttention(torch.autograd.Function):
    """K1/K2 forward, recompute-through-the-plain-version backward (B.4).

    The forward runs with grad off, so the kernels' wrappers launch; on a CPU
    tensor they run the plain version instead. Under
    ``torch.utils.checkpoint`` the forward runs again in the recompute, so a
    layer launches its kernel twice, as ``jax.checkpoint`` does.
    """

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask):
        ctx.save_for_backward(q, k, v, key_padding_mask)
        out = _kernel_forward(q, k, v, key_padding_mask)
        if q.device.type == "cuda":
            launch_counts["attention_diff"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_padding_mask = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = attention_reference(q, k, v, key_padding_mask)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None


def multi_head_attention(q, k, v, key_padding_mask=None):
    """Plain version on the CPU; on the card K1 or K2, through
    :class:`KernelAttention` when a gradient is wanted (see module doc)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_padding_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return KernelAttention.apply(q, k, v, key_padding_mask)
    return _kernel_forward(q, k, v, key_padding_mask)

