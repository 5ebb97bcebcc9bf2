"""ResNet backbone with frozen BatchNorm.

Mirrors ``office_person_detection_vit_tpu/models/resnet.py`` (torchvision/HF
ResNet v1.5: stride on the 3x3). Convolutions are ``F.conv2d`` (the JAX
package leaves them to XLA) and take NCHW views of channels-last tensors, so
cuDNN runs them channels-last. Padding follows the Flax module: the stem is
(3, 3), the 3x3 is (d, d) with dilation d, the 1x1 convolutions pad nothing,
and the 3/2 max pool pads with -inf.

Submodule names are the Flax module names, so a Flax parameter path maps to
the port's state_dict key directly (models/weights.py). FrozenBN's ``scale``
and ``bias`` are parameters, as the Flax module's ``self.param`` are: a
training step updates them with the backbone group. Parameters stay in their
own dtype and are cast to the input's at use (models/layers.py).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


class FrozenBatchNorm(nn.Module):
    """Per-channel affine y = x * scale + bias (BatchNorm folded)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x (B, C, H, W)
        return x * self.scale.to(x.dtype)[:, None, None] + self.bias.to(x.dtype)[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0, dilation: int = 1):
    return Conv2d(cin, cout, k, stride=stride, padding=padding, dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 (stride, dilation) -> 1x1 expand, plus shortcut."""

    def __init__(self, in_features: int, mid_features: int, out_features: int,
                 stride: int = 1, dilation: int = 1):
        super().__init__()
        if stride != 1 or in_features != out_features:
            self.shortcut_conv = _conv(in_features, out_features, 1, stride)
            self.shortcut_bn = FrozenBatchNorm(out_features)
        else:
            self.shortcut_conv = None
        self.conv0 = _conv(in_features, mid_features, 1)
        self.bn0 = FrozenBatchNorm(mid_features)
        self.conv1 = _conv(mid_features, mid_features, 3, stride, dilation, dilation)
        self.bn1 = FrozenBatchNorm(mid_features)
        self.conv2 = _conv(mid_features, out_features, 1)
        self.bn2 = FrozenBatchNorm(out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.shortcut_conv is not None:
            residual = self.shortcut_bn(self.shortcut_conv(x))
        y = torch.relu(self.bn0(self.conv0(x)))
        y = torch.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """Returns the last stage's feature map, (B, H/32, W/32, C) NHWC
    ((B, H/16, W/16, C) with ``dilate_last_stage``, DETR-DC5); with
    ``return_pyramid`` the last three stages' maps (C3, C4, C5 at strides 8,
    16, 32), as the single-shot detector takes them."""

    def __init__(self, depths: Sequence[int] = (3, 4, 6, 3),
                 hidden_sizes: Sequence[int] = (256, 512, 1024, 2048),
                 embedding_size: int = 64, dilate_last_stage: bool = False,
                 return_pyramid: bool = False):
        super().__init__()
        self.return_pyramid = return_pyramid
        self.stage_ends: list[str] = []
        self.embedder_conv = _conv(3, embedding_size, 7, 2, 3)
        self.embedder_bn = FrozenBatchNorm(embedding_size)
        self.blocks: list[str] = []
        in_feat = embedding_size
        for s, (depth, hidden) in enumerate(zip(depths, hidden_sizes)):
            dilate = dilate_last_stage and s == len(depths) - 1
            for layer in range(depth):
                stride = 2 if (layer == 0 and s > 0 and not dilate) else 1
                name = f"stage{s}_layer{layer}"
                self.add_module(name, Bottleneck(in_feat, hidden // 4, hidden, stride,
                                                 2 if dilate else 1))
                self.blocks.append(name)
                in_feat = hidden
            self.stage_ends.append(self.blocks[-1])

    def forward(self, x: torch.Tensor):  # x (B, H, W, 3)
        y = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        y = torch.relu(self.embedder_bn(self.embedder_conv(y)))
        y = F.max_pool2d(y, 3, 2, 1)
        stages = []
        for name in self.blocks:
            y = getattr(self, name)(y)
            if name in self.stage_ends:
                stages.append(y.permute(0, 2, 3, 1))
        return tuple(stages[-3:]) if self.return_pyramid else stages[-1]
