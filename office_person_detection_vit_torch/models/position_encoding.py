"""2D sine position embeddings for DETR, mask-aware.

Mirrors ``office_person_detection_vit_tpu/models/position_encoding.py``
(HF DetrSinePositionEmbedding: normalize, temperature 1e4, scale 2*pi):
cumulative sums of the mask per axis, normalized by the row/column totals
(+1e-6), interleaved sin/cos, y part first; NHWC output.
"""

from __future__ import annotations

import math

import torch


def sine_position_embedding(
    mask: torch.Tensor,
    embedding_dim: int = 128,
    temperature: float = 10000.0,
    normalize: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """mask (B, H, W) bool -> (B, H, W, 2 * embedding_dim) float32."""
    if scale is None:
        scale = 2 * math.pi
    m = mask.to(torch.float32)
    y_embed = torch.cumsum(m, dim=1)
    x_embed = torch.cumsum(m, dim=2)
    if normalize:
        y_embed = y_embed / (y_embed[:, -1:, :] + 1e-6) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + 1e-6) * scale

    dim_t = torch.arange(embedding_dim, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / embedding_dim)

    def interleave(p: torch.Tensor) -> torch.Tensor:
        p = torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])], dim=-1)
        return p.flatten(-2)

    pos_x = interleave(x_embed[..., None] / dim_t)
    pos_y = interleave(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)
