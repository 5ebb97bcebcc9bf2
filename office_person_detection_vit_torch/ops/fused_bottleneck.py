"""Fused identity ResNet bottleneck (1x1 -> 3x3 -> 1x1 + residual).

Mirrors ``office_person_detection_vit_tpu/ops/fused_bottleneck.py``. The block
is the identity (stride 1, no projection) bottleneck with frozen BN folded
into the convolutions, the semantics of ``models/resnet.py::Bottleneck``:

    y1 = relu(x @ W1 + b1)            # 1x1 reduce  C -> M
    y2 = relu(conv3x3(y1, W2) + b2)   # 3x3, SAME   M -> M
    out = relu(x + y2 @ W3 + b3)      # 1x1 expand  M -> C

Layouts are the JAX package's: x (B, H, W, C) NHWC, W1 (C, M), W2 (3, 3, M,
M) HWIO, W3 (M, C) in x's type, biases float32. :func:`bottleneck_reference`
is the plain version; :func:`fused_bottleneck` runs it for CPU tensors and the
hand-written CUDA kernel (``kernels/bottleneck.py``, K3) for CUDA tensors.
:func:`fold_identity_bottleneck` turns a port ``Bottleneck`` module into the
kernel's weights. The port's ResNet does not call the fused block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import full_float32
from ..models.resnet import Bottleneck


def bottleneck_reference(x, w1, b1, w2, b2, w3, b3, *, accumulate: torch.dtype = torch.float32) -> torch.Tensor:
    """The same block with plain convolutions, rounding where the JAX
    ``bottleneck_reference`` does: each convolution runs in float32 on the
    upcast values and adds its bias in float32, y1 and y2 are rounded to x's
    type, the residual is added in float32 and the output cast to x's type.

    ``accumulate=torch.float64`` runs the convolutions, the biases and the
    residual in float64 instead (each value rounded to float32 before it is
    rounded to x's type): the same rounding points with exact sums. A bf16
    kernel is held there on the card, since the float32 convolutions' own
    rounding moves some y1 and y2 values across bf16 rounding points (PERF.md).

    TF32 is off inside (:func:`~office_person_detection_vit_torch.device.full_float32`),
    and the caller's setting is restored after: the float32 convolutions
    are float32 whatever the caller's cuDNN flags say.
    """
    dtype, acc = x.dtype, accumulate

    def round_to_x(t):
        return t.float().to(dtype).to(acc)

    def oihw_1x1(w):  # (Cin, Cout) -> (Cout, Cin, 1, 1)
        return w.to(acc).t()[:, :, None, None]

    with full_float32():
        xf = x.to(acc).permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        y = round_to_x(torch.relu(F.conv2d(xf, oihw_1x1(w1), b1.to(acc))))
        y = round_to_x(torch.relu(F.conv2d(y, w2.to(acc).permute(3, 2, 0, 1), b2.to(acc), padding=1)))
        y = F.conv2d(y, oihw_1x1(w3), b3.to(acc))
    return torch.relu(y + xf).float().to(dtype).permute(0, 2, 3, 1).contiguous()


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, *, tile_h: int = 8) -> torch.Tensor:
    """relu(x + conv1x1(relu(conv3x3(relu(conv1x1(x)))))), one kernel on the card.

    x: (B, H, W, C); w1: (C, M); w2: (3, 3, M, M) HWIO; w3: (M, C); biases
    are the folded frozen-BN affine terms. H must be divisible by tile_h, the
    rows of output pixels one block owns. Returns x.dtype. CPU tensors take
    the plain version; CUDA tensors launch K3 or raise
    (:func:`~office_person_detection_vit_torch.kernels.bottleneck.fused_bottleneck`).
    """
    from ..kernels import bottleneck as kernels

    return kernels.fused_bottleneck(x, w1, b1, w2, b2, w3, b3, tile_h=tile_h)


@torch.no_grad()
def fold_identity_bottleneck(block: Bottleneck):
    """A port ``Bottleneck`` -> (w1, b1, w2, b2, w3, b3) in the layouts above.

    Each FrozenBN scale is folded into its convolution's output channels
    (w1[c, m] = conv0.weight[m, c] * bn0.scale[m], and so on), in float32,
    then cast to the convolution's dtype; the biases are the BN biases in
    float32. Raises on a block with a shortcut convolution or a 3x3 with
    stride or dilation other than 1: the fused kernel has neither.
    """
    if block.shortcut_conv is not None:
        raise ValueError("the fused bottleneck takes identity blocks only; this one has a shortcut conv")
    if block.conv1.stride != (1, 1) or block.conv1.dilation != (1, 1):
        raise ValueError(
            f"the fused bottleneck takes a stride-1, dilation-1 3x3; got stride "
            f"{block.conv1.stride}, dilation {block.conv1.dilation}"
        )
    dtype = block.conv0.weight.dtype

    def scaled(conv, bn):  # (O, I, kh, kw) * scale[O], float32
        return conv.weight.float() * bn.scale.float()[:, None, None, None]

    w1 = scaled(block.conv0, block.bn0)[:, :, 0, 0].t()
    w2 = scaled(block.conv1, block.bn1).permute(2, 3, 1, 0)
    w3 = scaled(block.conv2, block.bn2)[:, :, 0, 0].t()
    # detach: a float32 BN bias is returned as is by .float(), and it is a
    # parameter now that FrozenBN trains.
    return tuple(t.detach() for t in (
        w1.to(dtype).contiguous(), block.bn0.bias.float().contiguous(),
        w2.to(dtype).contiguous(), block.bn1.bias.float().contiguous(),
        w3.to(dtype).contiguous(), block.bn2.bias.float().contiguous(),
    ))
