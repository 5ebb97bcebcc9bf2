"""CLIP image tower: the appearance model of Re-ID's ``model_type: clip``.

The port's form of the part of ``transformers``' ``FlaxCLIPModel`` that the
JAX package's Re-ID extractor calls, ``get_image_features``
(``office_person_detection_vit_tpu/tracking/reid_feature_extractor.py``):
a ViT with a stride-P patch convolution (no bias), a class embedding and
learned position embeddings, ``pre_layrnorm``, N pre-norm blocks (quick-GELU
MLP), ``post_layernorm`` on the class token, and ``visual_projection``
(no bias). Only the vision tower and its projection are kept; the text
tower is never loaded.

The module names are the Flax module names (and HF's torch names, but for
the position embedding's leaf, ``embedding`` in Flax and ``weight`` in
torch), so ``models/weights.py`` carries a Flax or a torch checkpoint across
by name. Attention goes through the port's ``MultiHeadAttention``: the plain
version on the CPU, the CUDA kernels on the card. At ViT-B/32's widths
(224 px, patch 32: 50 tokens, 12 heads of 64) a float32 forward is 12 K1
launches, whatever the batch.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, LayerNorm, Linear
from .transformer import MultiHeadAttention

#: CLIP's pixel normalisation (RGB), as the JAX extractor applies it.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class CLIPVisionConfig:
    """The fields of HF's ``CLIPVisionConfig`` that the tower reads, and the
    top-level ``projection_dim``. The defaults are
    openai/clip-vit-base-patch32's."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 512

    @classmethod
    def from_hf(cls, doc: Mapping[str, Any]) -> "CLIPVisionConfig":
        """A checkpoint's ``config.json``: a ``CLIPModel`` one (its
        ``vision_config`` and ``projection_dim``) or a vision-only one."""
        vision = dict(doc.get("vision_config", doc))
        if "projection_dim" in doc:
            vision["projection_dim"] = doc["projection_dim"]
        names = {f.name for f in fields(cls)}
        c = cls(**{k: v for k, v in vision.items() if k in names})
        if c.hidden_act not in ACTIVATIONS:
            raise ValueError(f"unsupported CLIP hidden_act {c.hidden_act!r} (expected one of {sorted(ACTIVATIONS)})")
        return c

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": lambda x: F.gelu(x, approximate="none")}


class PositionEmbedding(nn.Module):
    """A learned (positions, hidden) table; its leaf is Flax's ``embedding``."""

    def __init__(self, n: int, d: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(n, d))


class CLIPEmbeddings(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.patch_embedding = Conv2d(c.num_channels, c.hidden_size, c.patch_size, stride=c.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(c.hidden_size))
        self.position_embedding = PositionEmbedding(c.num_positions, c.hidden_size)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(pixels).flatten(2).transpose(1, 2)  # (B, grid^2, hidden), row-major
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.embedding.to(x.dtype)


class CLIPMLP(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.act = ACTIVATIONS[c.hidden_act]
        self.fc1 = Linear(c.hidden_size, c.intermediate_size)
        self.fc2 = Linear(c.intermediate_size, c.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPLayer(nn.Module):
    """Pre-norm block: x += attn(LN1(x)); x += mlp(LN2(x))."""

    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.self_attn = MultiHeadAttention(c.hidden_size, c.num_attention_heads)
        self.layer_norm1 = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.mlp = CLIPMLP(c)
        self.layer_norm2 = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.layer_norm1(x)
        x = x + self.self_attn(h, h, h, None)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPLayer(c) for _ in range(c.num_hidden_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class CLIPVisionTransformer(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(c)
        self.pre_layrnorm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.encoder = CLIPEncoder(c)
        self.post_layernorm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) normalised pixels -> (B, hidden) pooled output: the
        class token after the last block and ``post_layernorm``."""
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixels)))
        return self.post_layernorm(x[:, 0])


class CLIPImageTower(nn.Module):
    """``get_image_features``: (B, 3, S, S) normalised float32 pixels ->
    (B, projection_dim) image embeddings (not normalised)."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)
        self.visual_projection = Linear(config.hidden_size, config.projection_dim, bias=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> None:
        """Seeded random weights: N(0, std) for every matrix and embedding,
        LayerNorm at (1, 0), biases 0."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif "norm" in name:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * std)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.visual_projection(self.vision_model(pixels))
