"""DETR person detector: ResNet backbone, 1x1 projection, post-norm
encoder/decoder with sine spatial and learned query embeddings, class head and
3-layer box MLP.

Mirrors ``office_person_detection_vit_tpu/models/detr.py``. ``DETRConfig``
carries the tiny/small/full tiers and every field that changes the forward
pass. ``use_pallas_attention`` is accepted so configs carry over, and is
ignored: on the card attention always runs the CUDA kernels. The backbone is
ResNet; the ``vit`` backbone waits for a later slice.

In bfloat16 the weights are rounded to bf16 once, when the model is moved to
its dtype, which matches Flax computing in ``dtype`` from float32 params.
Logits and boxes come back in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .position_encoding import sine_position_embedding
from .resnet import FrozenBatchNorm, ResNet
from .transformer import Decoder, Encoder

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class DETRConfig:
    num_queries: int = 100
    d_model: int = 256
    num_heads: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    ffn_dim: int = 2048
    num_classes: int = 91  # COCO labels; +1 no-object column in the head
    backbone_depths: tuple[int, ...] = (3, 4, 6, 3)
    backbone_hidden: tuple[int, ...] = (256, 512, 1024, 2048)
    backbone_embedding: int = 64
    #: DETR-DC5: last stage at stride 1 / dilation 2, feature stride 16.
    dilate_c5: bool = False
    #: Initial real-class bias -log((1-p)/p) of the class head (focal mode).
    class_prior: float | None = None
    #: 1-logit objectness head on the encoder output (training signal).
    enc_objectness: bool = False
    #: "softmax" (CE head) | "sigmoid" (focal head): how postprocess scores.
    score_mode: str = "softmax"
    dtype: str = "float32"
    #: Read for config compatibility and ignored (see module docstring).
    use_pallas_attention: bool = False
    person_class_id: int = 1  # COCO "person"

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @classmethod
    def tiny(cls, **kw) -> "DETRConfig":
        """Test tier: d_model 64, 4 heads, 2+2 layers, R(1,1,1,1)."""
        defaults = dict(
            num_queries=10, d_model=64, num_heads=4, num_encoder_layers=2,
            num_decoder_layers=2, ffn_dim=128, backbone_depths=(1, 1, 1, 1),
            backbone_hidden=(32, 64, 128, 256), backbone_embedding=16,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def small(cls, **kw) -> "DETRConfig":
        """Middle tier (~2.5M params) of the committed trained checkpoint."""
        defaults = dict(
            num_queries=25, d_model=128, num_heads=8, num_encoder_layers=3,
            num_decoder_layers=3, ffn_dim=512, backbone_depths=(2, 2, 2, 2),
            backbone_hidden=(64, 128, 256, 512), backbone_embedding=32,
            enc_objectness=True,
        )
        defaults.update(kw)
        return cls(**defaults)


class BBoxMLP(nn.Module):
    """3-layer MLP box head (DETR bbox_predictor)."""

    def __init__(self, hidden: int):
        super().__init__()
        self.dense0 = nn.Linear(hidden, hidden)
        self.dense1 = nn.Linear(hidden, hidden)
        self.dense2 = nn.Linear(hidden, 4)

    def forward(self, x):
        x = torch.relu(self.dense0(x))
        x = torch.relu(self.dense1(x))
        return self.dense2(x)


def _prior_logit(p: float) -> float:
    return -math.log((1.0 - p) / p)


class DETR(nn.Module):
    """pixel_values (B, H, W, 3) NHWC + pixel_mask (B, H, W) bool -> dict:
    logits (B, Q, num_classes + 1) float32, boxes (B, Q, 4) float32 sigmoid
    cxcywh normalized to the padded input, encoder_output (B, L, C),
    feature_hw; with ``enc_objectness`` also enc_obj_logits (B, L) and
    feature_mask (B, fh, fw)."""

    def __init__(self, config: DETRConfig = DETRConfig()):
        super().__init__()
        self.config = config
        c = config
        self.backbone = ResNet(c.backbone_depths, c.backbone_hidden, c.backbone_embedding,
                               dilate_last_stage=c.dilate_c5)
        self.input_projection = nn.Conv2d(c.backbone_hidden[-1], c.d_model, 1)
        self.query_position_embeddings = nn.Parameter(torch.empty(c.num_queries, c.d_model))
        self.encoder = Encoder(c.d_model, c.num_heads, c.ffn_dim, c.num_encoder_layers)
        self.decoder = Decoder(c.d_model, c.num_heads, c.ffn_dim, c.num_decoder_layers)
        self.class_labels_classifier = nn.Linear(c.d_model, c.num_classes + 1)
        self.bbox_predictor = BBoxMLP(c.d_model)
        if c.enc_objectness:
            self.encoder_objectness = nn.Linear(c.d_model, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random init with the Flax initializers' shapes of law:
        LeCun-normal kernels, zero biases, N(0, 1) query embeddings, identity
        frozen BN and LayerNorm, and the prior biases of the config."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm,)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, FrozenBatchNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
        self.query_position_embeddings.normal_(0.0, 1.0, generator=generator)
        if self.config.class_prior is not None:
            self.class_labels_classifier.bias.fill_(_prior_logit(self.config.class_prior))
            self.class_labels_classifier.bias[-1] = 0.0
        if self.config.enc_objectness:
            self.encoder_objectness.bias.fill_(_prior_logit(0.01))

    def forward(self, pixel_values: torch.Tensor, pixel_mask: torch.Tensor | None = None):
        cfg = self.config
        dtype = cfg.torch_dtype
        B, H, W, _ = pixel_values.shape
        if pixel_mask is None:
            pixel_mask = torch.ones((B, H, W), dtype=torch.bool, device=pixel_values.device)

        feat = self.backbone(pixel_values.to(dtype))  # (B, fh, fw, C5)
        fh, fw = feat.shape[1], feat.shape[2]

        # Nearest mask downsample as torch F.interpolate(mode="nearest") and
        # the JAX model index it: src = floor(dst * H / fh), in float32.
        dev = pixel_mask.device
        idx_y = np.floor(np.arange(fh, dtype=np.float32) * np.float32(H / fh)).astype(np.int64)
        idx_x = np.floor(np.arange(fw, dtype=np.float32) * np.float32(W / fw)).astype(np.int64)
        fmask = pixel_mask[:, torch.from_numpy(idx_y).to(dev)][:, :, torch.from_numpy(idx_x).to(dev)]

        pos = sine_position_embedding(fmask, embedding_dim=cfg.d_model // 2).to(dtype)
        proj = self.input_projection(feat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

        src = proj.reshape(B, fh * fw, cfg.d_model)
        pos_flat = pos.reshape(B, fh * fw, cfg.d_model)
        key_mask = fmask.reshape(B, fh * fw).contiguous()

        memory = self.encoder(src, pos_flat, key_mask)
        query_pos = self.query_position_embeddings.to(dtype)[None].expand(B, -1, -1)
        hs = self.decoder(torch.zeros_like(query_pos), query_pos, memory, pos_flat, key_mask)

        out = {
            "logits": self.class_labels_classifier(hs[-1]).float(),
            "boxes": torch.sigmoid(self.bbox_predictor(hs[-1]).float()),
            "encoder_output": memory,
            "feature_hw": (fh, fw),
        }
        if cfg.enc_objectness:
            out["enc_obj_logits"] = self.encoder_objectness(memory)[..., 0].float()
            out["feature_mask"] = fmask
        return out
