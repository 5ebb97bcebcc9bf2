"""ViT backbone: the detector's namesake, ``detection.backbone: vit``.

Mirrors ``office_person_detection_vit_tpu/models/vit.py``: an HF ``ViTModel``
encoder (pre-norm blocks, LayerNorm epsilon 1e-12, exact GELU, a CLS token
that takes part in attention, learned position embeddings) that turns
(B, H, W, 3) pixels into a (B, H/P, W/P, hidden) feature map for DETR. The
module names are the Flax ones, so ``models/weights.py`` carries JAX and HF
weights across by name.

The P x P stride-P patch embedding is a convolution (cuDNN on the card, as
the JAX package leaves it to XLA). Attention goes through the port's
``MultiHeadAttention``: the plain version on the CPU, the CUDA kernels on the
card (no mask, every token valid; ViT-base's head dim 64 at 736x1280 runs K2
on 46 x 80 + 1 = 3681 tokens). Away from the native grid the position
embeddings are resized bicubically with ``antialias=True``, which gives
``jax.image.resize(..., "bicubic")``'s Keys kernel (a = -0.5) and edge
weights; PyTorch's default bicubic (a = -0.75, no antialias) differs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, LayerNorm, Linear
from .transformer import MultiHeadAttention

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    #: native position-embedding grid (14 for the 224-trained HF models)
    pos_grid: int = 14
    layer_norm_eps: float = 1e-12
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        """Test tier: patch 8, hidden 64, 2 layers of 4 heads (head dim 16)."""
        defaults = dict(patch_size=8, hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128, pos_grid=4)
        defaults.update(kw)
        return cls(**defaults)


class ViTBlock(nn.Module):
    """Pre-norm block (HF ViTLayer): x += attn(LN(x)); x += mlp(LN(x))."""

    def __init__(self, c: ViTConfig):
        super().__init__()
        self.layernorm_before = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.attention = MultiHeadAttention(c.hidden_size, c.num_heads)
        self.layernorm_after = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.intermediate = Linear(c.hidden_size, c.mlp_dim)
        self.output = Linear(c.mlp_dim, c.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.layernorm_before(x)
        x = x + self.attention(h, h, h, None)
        h = F.gelu(self.intermediate(self.layernorm_after(x)), approximate="none")
        return x + self.output(h)


def resize_position_grid(grid: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """(1, g, g, C) position embeddings -> (1, h, w, C), bicubic as
    ``jax.image.resize(..., "bicubic")`` computes it (antialiased Keys
    cubic, half-pixel centres), in float32."""
    x = grid.float().permute(0, 3, 1, 2)
    x = F.interpolate(x, size=hw, mode="bicubic", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


class ViTBackbone(nn.Module):
    """(B, H, W, 3) pixels, H and W multiples of the patch -> (B, H/P, W/P,
    hidden). The CLS token takes part in attention and is dropped from the
    output, so at the native grid the features are
    ``ViTModel.last_hidden_state[:, 1:]``."""

    def __init__(self, config: ViTConfig = ViTConfig()):
        super().__init__()
        self.config = c = config
        P = c.patch_size
        self.patch_embed = Conv2d(3, c.hidden_size, P, stride=P)
        self.cls_token = nn.Parameter(torch.empty(1, 1, c.hidden_size))
        self.position_embeddings = nn.Parameter(torch.empty(1, 1 + c.pos_grid * c.pos_grid, c.hidden_size))
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", ViTBlock(c))
        self.layernorm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    @torch.no_grad()
    def init_embeddings(self, generator: torch.Generator) -> None:
        """N(0, 0.02) CLS token and position embeddings, as the Flax module."""
        self.cls_token.normal_(0.0, 0.02, generator=generator)
        self.position_embeddings.normal_(0.0, 0.02, generator=generator)

    def position_embedding(self, fh: int, fw: int) -> torch.Tensor:
        """(1, 1 + fh * fw, hidden) float32: the CLS entry, then the grid
        resized to (fh, fw) where it is not the native one."""
        c = self.config
        pos = self.position_embeddings.float()
        grid = pos[:, 1:].reshape(1, c.pos_grid, c.pos_grid, c.hidden_size)
        if (fh, fw) != (c.pos_grid, c.pos_grid):
            grid = resize_position_grid(grid, (fh, fw))
        return torch.cat([pos[:, :1], grid.reshape(1, fh * fw, c.hidden_size)], dim=1)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        c = self.config
        dtype = c.torch_dtype
        P = c.patch_size
        B, H, W, _ = pixels.shape
        if H % P or W % P:
            raise ValueError(f"input {H}x{W} not a multiple of patch {P}")
        x = self.patch_embed(pixels.to(dtype).permute(0, 3, 1, 2))  # (B, hidden, fh, fw)
        fh, fw = x.shape[2], x.shape[3]
        tokens = x.flatten(2).transpose(1, 2)  # (B, fh * fw, hidden), row-major over the grid
        cls = self.cls_token.to(dtype).expand(B, 1, c.hidden_size)
        x = torch.cat([cls, tokens], dim=1) + self.position_embedding(fh, fw).to(dtype)
        for i in range(c.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        x = self.layernorm(x)
        return x[:, 1:].reshape(B, fh, fw, c.hidden_size)
