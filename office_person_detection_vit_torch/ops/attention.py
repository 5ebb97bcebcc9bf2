"""Multi-head attention: the plain version and the dispatch to the kernels.

Mirrors ``office_person_detection_vit_tpu/ops/attention.py``.
:func:`attention_reference` is the plain PyTorch version of
``attention_reference`` there. :func:`multi_head_attention` runs it for CPU
tensors; for CUDA tensors it runs the hand-written kernels of
``kernels/attention.py`` and nothing else: whole-KV (K1) or flash (K2) as
:func:`~office_person_detection_vit_torch.kernels.attention.use_flash` decides
(it states the rule and the H100 measurement behind it). The JAX package's ``use_pallas_attention``
choice has no counterpart here: on the card attention is always the kernel.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


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


def multi_head_attention(q, k, v, key_padding_mask=None):
    """Plain version on the CPU; K1 or K2 on the card (see module doc)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_padding_mask)
    from ..kernels import attention as kernels

    if kernels.use_flash(k.shape[2], q.shape[3], q.dtype):
        return kernels.attention_flash(q, k, v, key_padding_mask)
    return kernels.attention_whole_kv(q, k, v, key_padding_mask)

