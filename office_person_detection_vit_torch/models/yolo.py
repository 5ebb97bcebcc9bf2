"""YOLOv8: the reference's shipping detector (it fine-tuned ultralytics
YOLOv8x and served it).

Mirrors ``office_person_detection_vit_tpu/models/yolo.py``: ``VARIANTS`` and
``YOLOConfig`` (:40-95); ``ConvBlock`` (conv, frozen BN, SiLU),
``Bottleneck``, ``C2f``, ``SPPF`` and the anchor-free ``Detect`` head with
ultralytics' bias init (:97-221); ``YOLOv8`` with the yolov8.yaml module
indices (:224-271); ``dfl_expectation`` (:274) and ``decode_yolo`` (:284).

The JAX module is NHWC; here the maps are NCHW views of channels-last memory
(the input's permute, as ``models/resnet.py`` does), so cuDNN runs the
convolutions channels-last. Concatenations are on the channel axis in the
yolov8.yaml order (the upsampled map first) and the 2x upsample is nearest,
as ``jnp.repeat`` is. The raw outputs come back NHWC and float32, as Flax
returns them. Submodule names are the Flax module names (``m{i}``,
``detect/cv2_{l}_{s}``), so ``models/weights.py`` maps a Flax path to the
port's key by the same walk as for DETR. No Pallas kernel is involved: the
convolutions, SiLU, the DFL softmax and NMS are ordinary torch/cuDNN calls,
as XLA computed them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .detr import DTYPES
from .layers import Conv2d
from .resnet import FrozenBatchNorm
from .single_shot import candidates_to_batch, lecun_init, orig_wh_tensors, upsample2x

#: (depth_multiple, width_multiple, max_channels) per ultralytics variant;
#: "tiny" is the JAX package's test-scale variant (1/8 width, depth 1).
VARIANTS: dict[str, tuple[float, float, int]] = {
    "n": (1 / 3, 0.25, 1024),
    "s": (1 / 3, 0.50, 1024),
    "m": (2 / 3, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
    "tiny": (1 / 3, 0.125, 1024),
}

#: Base channel plan of the yolov8.yaml backbone stages.
_BASE_CH = (64, 128, 256, 512, 1024)
#: Base bottleneck counts of the C2f blocks at module indices 2/4/6/8.
_BASE_DEPTH = (3, 6, 6, 3)


def _make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(math.ceil(x / divisor) * divisor))


@dataclass(frozen=True)
class YOLOConfig:
    variant: str = "x"
    num_classes: int = 1  # person-only, like the reference's fine-tune
    reg_max: int = 16
    strides: tuple[int, ...] = (8, 16, 32)
    max_detections: int = 100
    nms_iou_threshold: float = 0.45
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def multiples(self) -> tuple[float, float, int]:
        return VARIANTS[self.variant]

    def width(self, c: int) -> int:
        """Scaled channel count: make_divisible(min(c, max_ch) * w, 8)."""
        _, w, mc = self.multiples
        return _make_divisible(min(c, mc) * w)

    def depth(self, n: int) -> int:
        return max(round(n * self.multiples[0]), 1)

    @classmethod
    def tiny(cls, **kw) -> "YOLOConfig":
        defaults = dict(variant="tiny", max_detections=10, dtype="float32")
        defaults.update(kw)
        return cls(**defaults)


class ConvBlock(nn.Module):
    """ultralytics ``Conv``: Conv2d (no bias, pad k//2) + frozen BN + SiLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)
        self.bn = FrozenBatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    """Two 3x3 ConvBlocks at full width, with the residual add when asked."""

    def __init__(self, c: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBlock(c, c, 3)
        self.cv2 = ConvBlock(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """Split ``cv1``'s 2*hidden channels in two, chain n bottlenecks on the
    second half, concatenate every part for ``cv2``."""

    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        self.hidden = hidden = features // 2
        self.n = n
        self.cv1 = ConvBlock(cin, 2 * hidden, 1)
        for j in range(n):
            self.add_module(f"m{j}", Bottleneck(hidden, shortcut))
        self.cv2 = ConvBlock((2 + n) * hidden, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        parts = [y[:, : self.hidden], y[:, self.hidden:]]
        for j in range(self.n):
            parts.append(getattr(self, f"m{j}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial-pyramid pooling (fast): three chained 5x5 stride-1 max pools."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        hidden = cin // 2
        self.cv1 = ConvBlock(cin, hidden, 1)
        self.cv2 = ConvBlock(4 * hidden, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
        return self.cv2(torch.cat(pools, dim=1))


class Detect(nn.Module):
    """Decoupled anchor-free head: per level a box branch (4 x reg_max DFL
    logits) and a class branch; no objectness."""

    def __init__(self, config: YOLOConfig, in_channels: tuple[int, ...]):
        super().__init__()
        self.config = config
        self.levels = len(in_channels)
        c2 = max(16, in_channels[0] // 4, 4 * config.reg_max)
        c3 = max(in_channels[0], min(config.num_classes, 100))
        for l, c in enumerate(in_channels):
            setattr(self, f"cv2_{l}_0", ConvBlock(c, c2, 3))
            setattr(self, f"cv2_{l}_1", ConvBlock(c2, c2, 3))
            setattr(self, f"cv2_{l}_2", Conv2d(c2, 4 * config.reg_max, 1))
            setattr(self, f"cv3_{l}_0", ConvBlock(c, c3, 3))
            setattr(self, f"cv3_{l}_1", ConvBlock(c3, c3, 3))
            setattr(self, f"cv3_{l}_2", Conv2d(c3, config.num_classes, 1))

    @torch.no_grad()
    def init_priors(self) -> None:
        """ultralytics ``Detect.bias_init``: box-distance bias 1.0; class bias
        log(5 / nc / (640 / stride)^2), about 5 objects a 640-px image."""
        cfg = self.config
        for l in range(self.levels):
            stride = cfg.strides[l] if l < len(cfg.strides) else 32
            getattr(self, f"cv2_{l}_2").bias.fill_(1.0)
            getattr(self, f"cv3_{l}_2").bias.fill_(math.log(5.0 / cfg.num_classes / (640.0 / stride) ** 2))

    def forward(self, feats: list[torch.Tensor]) -> list[dict]:
        levels = []
        for l, f in enumerate(feats):
            box = getattr(self, f"cv2_{l}_2")(getattr(self, f"cv2_{l}_1")(getattr(self, f"cv2_{l}_0")(f)))
            cls = getattr(self, f"cv3_{l}_2")(getattr(self, f"cv3_{l}_1")(getattr(self, f"cv3_{l}_0")(f)))
            levels.append({
                "box_dist": box.permute(0, 2, 3, 1).float(),  # (B, fh, fw, 4 * reg_max)
                "class_logits": cls.permute(0, 2, 3, 1).float(),  # (B, fh, fw, C)
            })
        return levels


class YOLOv8(nn.Module):
    """Backbone + PAN neck + Detect head; ``m{i}`` are the yolov8.yaml
    module indices (the parameter-free Upsample/Concat 10/11/13/14/17/20 have
    no module), the head is ``detect`` (index 22)."""

    def __init__(self, config: YOLOConfig):
        super().__init__()
        self.config = config
        ch = [config.width(c) for c in _BASE_CH]
        n = [config.depth(d) for d in _BASE_DEPTH]
        self.m0 = ConvBlock(3, ch[0], 3, 2)  # P1/2
        self.m1 = ConvBlock(ch[0], ch[1], 3, 2)  # P2/4
        self.m2 = C2f(ch[1], ch[1], n[0], True)
        self.m3 = ConvBlock(ch[1], ch[2], 3, 2)  # P3/8
        self.m4 = C2f(ch[2], ch[2], n[1], True)
        self.m5 = ConvBlock(ch[2], ch[3], 3, 2)  # P4/16
        self.m6 = C2f(ch[3], ch[3], n[2], True)
        self.m7 = ConvBlock(ch[3], ch[4], 3, 2)  # P5/32
        self.m8 = C2f(ch[4], ch[4], n[3], True)
        self.m9 = SPPF(ch[4], ch[4])
        self.m12 = C2f(ch[4] + ch[3], ch[3], n[0], False)
        self.m15 = C2f(ch[3] + ch[2], ch[2], n[0], False)  # P3 out
        self.m16 = ConvBlock(ch[2], ch[2], 3, 2)
        self.m18 = C2f(ch[2] + ch[3], ch[3], n[0], False)  # P4 out
        self.m19 = ConvBlock(ch[3], ch[3], 3, 2)
        self.m21 = C2f(ch[3] + ch[4], ch[4], n[0], False)  # P5 out
        self.detect = Detect(config, (ch[2], ch[3], ch[4]))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random init with Flax's laws (LeCun-normal kernels, zero
        biases, identity frozen BN), then the head's prior biases."""
        lecun_init(self, generator)
        self.detect.init_priors()

    def forward(self, pixel_values: torch.Tensor) -> dict:
        """(B, H, W, 3) normalized pixels -> {"levels": per level (finest
        first) box_dist and class_logits, NHWC float32; "features": P5 out,
        NHWC}."""
        x = pixel_values.to(self.config.torch_dtype).permute(0, 3, 1, 2)
        x = self.m2(self.m1(self.m0(x)))
        p3 = self.m4(self.m3(x))
        p4 = self.m6(self.m5(p3))
        p5 = self.m9(self.m8(self.m7(p4)))
        n4 = self.m12(torch.cat([upsample2x(p5), p4], dim=1))  # 10, 11
        o3 = self.m15(torch.cat([upsample2x(n4), p3], dim=1))  # 13, 14
        o4 = self.m18(torch.cat([self.m16(o3), n4], dim=1))  # 17
        o5 = self.m21(torch.cat([self.m19(o4), p5], dim=1))  # 20
        return {"levels": self.detect([o3, o4, o5]), "features": o5.permute(0, 2, 3, 1)}


def dfl_expectation(box_dist: torch.Tensor, reg_max: int) -> torch.Tensor:
    """(..., 4 reg_max) DFL logits -> (..., 4) expected (l, t, r, b) distances
    in cells: softmax over the bins dotted with arange(reg_max), the closed
    form of the checkpoint's fixed ``dfl.conv`` kernel."""
    p = torch.softmax(box_dist.reshape(*box_dist.shape[:-1], 4, reg_max), dim=-1)
    return (p * torch.arange(reg_max, dtype=torch.float32, device=box_dist.device)).sum(-1)


def decode_yolo(outputs: dict, orig_wh, input_hw: tuple[int, int], config: YOLOConfig,
                confidence_threshold: float, host: bool = True):
    """Raw head outputs -> host ``DetectionBatch`` (F, max_detections): DFL
    decode of each level, the candidates of all levels, then
    :func:`~office_person_detection_vit_torch.models.single_shot.candidates_to_batch`."""
    levels = outputs["levels"]
    dev = levels[0]["class_logits"].device
    W, H = orig_wh_tensors(orig_wh, dev)
    th, tw = input_hw
    inv = 1.0 / torch.minimum(th / H, tw / W)
    scores, boxes = [], []
    for level, stride in zip(levels, config.strides):
        cls = level["class_logits"]
        B, fh, fw, _ = cls.shape
        ltrb = dfl_expectation(level["box_dist"], config.reg_max)
        score = torch.sigmoid(cls).amax(-1)
        cx = (torch.arange(fw, dtype=torch.float32, device=dev) + 0.5)[None, None, :]
        cy = (torch.arange(fh, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
        x0 = (cx - ltrb[..., 0]) * stride
        y0 = (cy - ltrb[..., 1]) * stride
        x1 = (cx + ltrb[..., 2]) * stride
        y1 = (cy + ltrb[..., 3]) * stride
        scores.append(score.reshape(B, -1))
        boxes.append(torch.stack([c.reshape(B, -1) for c in (x0, y0, x1, y1)], dim=-1) * inv)
    return candidates_to_batch(torch.cat(scores, 1), torch.cat(boxes, 1), (W, H), config.max_detections,
                               config.nms_iou_threshold, confidence_threshold, host)
