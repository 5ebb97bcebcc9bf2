"""DETR transformer encoder/decoder (post-norm).

Mirrors ``office_person_detection_vit_tpu/models/transformer.py`` (HF
DetrEncoder/DetrDecoder semantics): position embeddings go to queries and
keys, never to values; attn -> add -> LayerNorm, FFN -> add -> LayerNorm; the
decoder's final LayerNorm is applied to every intermediate output. LayerNorm
epsilon is Flax's 1e-6, not torch's 1e-5. Attention goes through
``ops.attention.multi_head_attention``: the plain version on the CPU, the
CUDA kernels on the card. Inference only: no dropout.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import multi_head_attention

LN_EPS = 1e-6


def _ln(d_model: int) -> nn.LayerNorm:
    return nn.LayerNorm(d_model, eps=LN_EPS)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, query, key, value, key_padding_mask=None):
        """query (B, Lq, C) and key (B, Lk, C) with position embeddings,
        value (B, Lk, C) without; key_padding_mask (B, Lk) True = valid."""
        B, Lq, C = query.shape
        Lk = key.shape[1]
        H = self.num_heads

        def heads(x, L):
            return x.reshape(B, L, H, C // H).transpose(1, 2).contiguous()

        q = heads(self.q_proj(query), Lq)
        k = heads(self.k_proj(key), Lk)
        v = heads(self.v_proj(value), Lk)
        out = multi_head_attention(q, k, v, key_padding_mask)
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, C))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads)
        self.self_attn_layer_norm = _ln(d_model)
        self.fc1 = nn.Linear(d_model, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d_model)
        self.final_layer_norm = _ln(d_model)

    def forward(self, src, pos, key_padding_mask):
        qk = src + pos
        src = self.self_attn_layer_norm(src + self.self_attn(qk, qk, src, key_padding_mask))
        y = self.fc2(torch.relu(self.fc1(src)))
        return self.final_layer_norm(src + y)


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads)
        self.self_attn_layer_norm = _ln(d_model)
        self.encoder_attn = MultiHeadAttention(d_model, num_heads)
        self.encoder_attn_layer_norm = _ln(d_model)
        self.fc1 = nn.Linear(d_model, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, d_model)
        self.final_layer_norm = _ln(d_model)

    def forward(self, tgt, query_pos, memory, memory_pos, memory_key_padding_mask):
        qk = tgt + query_pos
        tgt = self.self_attn_layer_norm(tgt + self.self_attn(qk, qk, tgt, None))
        attn = self.encoder_attn(tgt + query_pos, memory + memory_pos, memory,
                                 memory_key_padding_mask)
        tgt = self.encoder_attn_layer_norm(tgt + attn)
        y = self.fc2(torch.relu(self.fc1(tgt)))
        return self.final_layer_norm(tgt + y)


class Encoder(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(d_model, num_heads, ffn_dim))

    def forward(self, src, pos, key_padding_mask):
        for i in range(self.num_layers):
            src = getattr(self, f"layer_{i}")(src, pos, key_padding_mask)
        return src


class Decoder(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(d_model, num_heads, ffn_dim))
        self.layernorm = _ln(d_model)

    def forward(self, tgt, query_pos, memory, memory_pos, memory_key_padding_mask):
        """-> (num_layers, B, Q, C), each layer's output through the final
        LayerNorm; the last entry is the decoder output."""
        intermediate = []
        for i in range(self.num_layers):
            tgt = getattr(self, f"layer_{i}")(tgt, query_pos, memory, memory_pos,
                                              memory_key_padding_mask)
            intermediate.append(tgt)
        return torch.stack([self.layernorm(h) for h in intermediate], dim=0)
