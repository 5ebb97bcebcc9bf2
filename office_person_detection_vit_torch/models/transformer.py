"""DETR transformer encoder/decoder (post-norm).

Mirrors ``office_person_detection_vit_tpu/models/transformer.py`` (HF
DetrEncoder/DetrDecoder semantics): position embeddings go to queries and
keys, never to values; attn -> add -> LayerNorm, FFN -> add -> LayerNorm; the
decoder's final LayerNorm is applied to every intermediate output. LayerNorm
epsilon is Flax's 1e-6, not torch's 1e-5. Attention goes through
``ops.attention.multi_head_attention``: the plain version on the CPU, the
CUDA kernels on the card (through ``KernelAttention`` when a gradient is
wanted).

Training: dropout sits where the JAX layers put it (``transformer.py:74,80,82``
in the encoder, ``:111,120,126,128`` in the decoder): on the attention output
and in the FFN, never on the probabilities. Each layer takes a seed (``None``:
no dropout) and draws its masks from a generator seeded with it, so a step is
reproducible and a layer rerun under ``torch.utils.checkpoint`` (``remat``,
the counterpart of ``nn.remat``) draws the same masks.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention_reference, multi_head_attention
from .layers import LayerNorm, Linear, dropout, layer_generator

LN_EPS = 1e-6


def _ln(d_model: int) -> LayerNorm:
    return LayerNorm(d_model, eps=LN_EPS)


def _run(layer: nn.Module, remat: bool, *args):
    if remat and torch.is_grad_enabled():
        return checkpoint(layer, *args, use_reentrant=False)
    return layer(*args)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        #: None, or a list that the next calls append their attention
        #: probabilities to: those calls run the plain version, which forms
        #: them (``DETRDetector.get_attention_map``).
        self.kept_probs: list | None = None
        self.q_proj = Linear(d_model, d_model)
        self.k_proj = Linear(d_model, d_model)
        self.v_proj = Linear(d_model, d_model)
        self.out_proj = Linear(d_model, d_model)

    def forward(self, query, key, value, key_padding_mask=None):
        """query (B, Lq, C) and key (B, Lk, C) with position embeddings,
        value (B, Lk, C) without; key_padding_mask (B, Lk) True = valid."""
        B, Lq, _ = query.shape
        Lk = key.shape[1]
        H = self.num_heads  # this rank's heads under tensor parallelism (parallel/sharding.py)

        def heads(x, L):
            return x.reshape(B, L, H, -1).transpose(1, 2).contiguous()

        q = heads(self.q_proj(query), Lq)
        k = heads(self.k_proj(key), Lk)
        v = heads(self.v_proj(value), Lk)
        if self.kept_probs is not None:
            out, probs = attention_reference(q, k, v, key_padding_mask, return_probs=True)
            self.kept_probs.append(probs)
        else:
            out = multi_head_attention(q, k, v, key_padding_mask)
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, -1))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, num_heads)
        self.self_attn_layer_norm = _ln(d_model)
        self.fc1 = Linear(d_model, ffn_dim)
        self.fc2 = Linear(ffn_dim, d_model)
        self.final_layer_norm = _ln(d_model)

    def forward(self, src, pos, key_padding_mask, seed=None):
        g = layer_generator(seed, src.device)
        qk = src + pos
        attn = dropout(self.self_attn(qk, qk, src, key_padding_mask), self.dropout, g)
        src = self.self_attn_layer_norm(src + attn)
        y = dropout(torch.relu(self.fc1(src)), self.dropout, g, getattr(self.fc1, "shard", None))
        y = dropout(self.fc2(y), self.dropout, g)
        return self.final_layer_norm(src + y)


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, num_heads)
        self.self_attn_layer_norm = _ln(d_model)
        self.encoder_attn = MultiHeadAttention(d_model, num_heads)
        self.encoder_attn_layer_norm = _ln(d_model)
        self.fc1 = Linear(d_model, ffn_dim)
        self.fc2 = Linear(ffn_dim, d_model)
        self.final_layer_norm = _ln(d_model)

    def forward(self, tgt, query_pos, memory, memory_pos, memory_key_padding_mask, seed=None):
        g = layer_generator(seed, tgt.device)
        qk = tgt + query_pos
        attn = dropout(self.self_attn(qk, qk, tgt, None), self.dropout, g)
        tgt = self.self_attn_layer_norm(tgt + attn)
        attn = self.encoder_attn(tgt + query_pos, memory + memory_pos, memory,
                                 memory_key_padding_mask)
        tgt = self.encoder_attn_layer_norm(tgt + dropout(attn, self.dropout, g))
        y = dropout(torch.relu(self.fc1(tgt)), self.dropout, g, getattr(self.fc1, "shard", None))
        y = dropout(self.fc2(y), self.dropout, g)
        return self.final_layer_norm(tgt + y)


class Encoder(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, num_layers: int,
                 dropout: float = 0.0, remat: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(d_model, num_heads, ffn_dim, dropout))

    def forward(self, src, pos, key_padding_mask, seeds=None):
        """``seeds``: one per layer (dropout on), or ``None``."""
        for i in range(self.num_layers):
            seed = None if seeds is None else seeds[i]
            src = _run(getattr(self, f"layer_{i}"), self.remat, src, pos, key_padding_mask, seed)
        return src


class Decoder(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, num_layers: int,
                 dropout: float = 0.0, remat: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(d_model, num_heads, ffn_dim, dropout))
        self.layernorm = _ln(d_model)

    def forward(self, tgt, query_pos, memory, memory_pos, memory_key_padding_mask, seeds=None):
        """-> (num_layers, B, Q, C), each layer's output through the final
        LayerNorm; the last entry is the decoder output."""
        intermediate = []
        for i in range(self.num_layers):
            seed = None if seeds is None else seeds[i]
            tgt = _run(getattr(self, f"layer_{i}"), self.remat, tgt, query_pos, memory,
                       memory_pos, memory_key_padding_mask, seed)
            intermediate.append(tgt)
        return torch.stack([self.layernorm(h) for h in intermediate], dim=0)
