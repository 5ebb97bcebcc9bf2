"""The single-shot anchor-free detector (FCOS-style), the framework's
alternate detector family, and the decode tail it shares with YOLOv8.

Mirrors ``office_person_detection_vit_tpu/models/single_shot.py``:
``SingleShotConfig`` (:35-67, ``tiny()`` included), the shared per-level
``_Head`` (:70), ``SingleShotDetector`` (:103: the ResNet-50 backbone's C3/C4/C5
with frozen BN, an FPN neck of lateral 1x1, top-down nearest-upsample add and
3x3 smooth, the head shared across levels), ``decode_single_shot`` (:148) and
``candidates_to_batch`` (:200-242: top-K, per-image greedy NMS, clip, xywh
and the foot point, the ``DetectionBatch`` contract of DETR's postprocess).

Maps are NCHW views of channels-last memory, as in ``models/resnet.py``; the
raw outputs come back NHWC and float32, as Flax returns them. Module names are
the Flax module names (``backbone``, ``lateral{i}``, ``smooth{i}``,
``head/{conv,gn}{0,1}``, ``head/{obj,cls,box}``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..core.dto import DetectionBatch
from ..ops.boxes import nms_mask
from .detr import DTYPES
from .layers import Conv2d
from .resnet import FrozenBatchNorm, ResNet


@torch.no_grad()
def lecun_init(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's default laws on every layer of ``model``: LeCun-normal conv
    kernels, zero biases, identity frozen BN and GroupNorm."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.weight[0].numel()), generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, FrozenBatchNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()


@dataclass(frozen=True)
class SingleShotConfig:
    num_classes: int = 1  # person-only by default
    head_dim: int = 256
    max_detections: int = 100
    #: FPN levels, finest first: the backbone's C3/C4/C5 strides.
    strides: tuple[int, ...] = (8, 16, 32)
    backbone_depths: tuple[int, ...] = (3, 4, 6, 3)
    backbone_hidden: tuple[int, ...] = (256, 512, 1024, 2048)
    backbone_embedding: int = 64
    dtype: str = "bfloat16"
    nms_iou_threshold: float = 0.45

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @classmethod
    def tiny(cls, **kw) -> "SingleShotConfig":
        defaults = dict(
            head_dim=32,
            max_detections=10,
            backbone_depths=(1, 1, 1, 1),
            backbone_hidden=(32, 64, 128, 256),
            backbone_embedding=16,
            dtype="float32",
        )
        defaults.update(kw)
        return cls(**defaults)


#: The focal prior logit(0.01) of the objectness and class biases.
PRIOR_LOGIT = -4.595


class Head(nn.Module):
    """The shared per-level head: two 3x3 conv + GroupNorm + SiLU blocks,
    then objectness, class and (l, t, r, b) convolutions (JAX ``_Head``)."""

    def __init__(self, head_dim: int, num_classes: int):
        super().__init__()
        groups = 32 if head_dim % 32 == 0 else 1
        for i in range(2):
            setattr(self, f"conv{i}", Conv2d(head_dim, head_dim, 3, padding=1))
            setattr(self, f"gn{i}", nn.GroupNorm(groups, head_dim, eps=1e-6))  # Flax's epsilon
        self.obj = Conv2d(head_dim, 1, 3, padding=1)
        self.cls = Conv2d(head_dim, num_classes, 3, padding=1)
        self.box = Conv2d(head_dim, 4, 3, padding=1)

    def forward(self, x: torch.Tensor) -> dict:
        for i in range(2):
            gn = getattr(self, f"gn{i}")
            x = getattr(self, f"conv{i}")(x)
            x = F.silu(F.group_norm(x, gn.num_groups, gn.weight.to(x.dtype), gn.bias.to(x.dtype), gn.eps))
        return {
            "objectness": self.obj(x)[:, 0].float(),
            "class_logits": self.cls(x).permute(0, 2, 3, 1).float(),
            "ltrb": F.softplus(self.box(x).permute(0, 2, 3, 1).float()),
        }


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of an NCHW map (``jnp.repeat`` twice in JAX)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class SingleShotDetector(nn.Module):
    def __init__(self, config: SingleShotConfig):
        super().__init__()
        self.config = config
        self.backbone = ResNet(config.backbone_depths, config.backbone_hidden, config.backbone_embedding,
                               return_pyramid=True)
        for i, c in enumerate(config.backbone_hidden[-3:]):
            setattr(self, f"lateral{i}", Conv2d(c, config.head_dim, 1))
            setattr(self, f"smooth{i}", Conv2d(config.head_dim, config.head_dim, 3, padding=1))
        self.head = Head(config.head_dim, config.num_classes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random init with Flax's laws, then the focal prior biases."""
        lecun_init(self, generator)
        self.head.obj.bias.fill_(PRIOR_LOGIT)
        self.head.cls.bias.fill_(PRIOR_LOGIT)

    def forward(self, pixel_values: torch.Tensor) -> dict:
        """(B, H, W, 3) normalized pixels -> {"levels": per level (finest
        first) objectness (B, fh, fw), class_logits and ltrb NHWC, float32;
        "features": C5, NHWC}."""
        c3, c4, c5 = (c.permute(0, 3, 1, 2) for c in self.backbone(pixel_values.to(self.config.torch_dtype)))
        lat = [getattr(self, f"lateral{i}")(c) for i, c in enumerate((c3, c4, c5))]
        p5 = lat[2]
        p4 = lat[1] + upsample2x(p5)
        p3 = lat[0] + upsample2x(p4)
        pyramid = [getattr(self, f"smooth{i}")(p) for i, p in enumerate((p3, p4, p5))]
        return {"levels": [self.head(p) for p in pyramid], "features": c5.permute(0, 2, 3, 1)}


def orig_wh_tensors(orig_wh, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, H) of the original frames as float32 scalars on ``device``, so that
    the decode's scale is computed in float32, as JAX computes it."""
    return tuple(torch.as_tensor(v, dtype=torch.float32, device=device) for v in orig_wh)


def decode_single_shot(outputs: dict, orig_wh, input_hw: tuple[int, int], config: SingleShotConfig,
                       confidence_threshold: float, host: bool = True) -> DetectionBatch:
    """Per-level raw head outputs -> host ``DetectionBatch`` (F,
    max_detections): score sigmoid(obj) x max sigmoid(cls), boxes from the
    cell centres in stride units, then :func:`candidates_to_batch`."""
    levels = outputs["levels"]
    dev = levels[0]["objectness"].device
    W, H = orig_wh_tensors(orig_wh, dev)
    th, tw = input_hw
    # The aspect-preserving, top-left-anchored resize: one scalar maps input
    # pixels back to the original's.
    inv = 1.0 / torch.minimum(th / H, tw / W)
    scores, boxes = [], []
    for level, stride in zip(levels, config.strides):
        obj, cls, ltrb = level["objectness"], level["class_logits"], level["ltrb"]
        B, fh, fw = obj.shape
        score = torch.sigmoid(obj) * torch.sigmoid(cls).amax(-1)
        cy = (torch.arange(fh, dtype=torch.float32, device=dev) + 0.5) * stride
        cx = (torch.arange(fw, dtype=torch.float32, device=dev) + 0.5) * stride
        l, t, r, b = (ltrb[..., i] * stride for i in range(4))
        x0 = cx[None, None, :] - l
        y0 = cy[None, :, None] - t
        x1 = cx[None, None, :] + r
        y1 = cy[None, :, None] + b
        scores.append(score.reshape(B, -1))
        boxes.append(torch.stack([c.reshape(B, -1) for c in (x0, y0, x1, y1)], dim=-1) * inv)
    return candidates_to_batch(torch.cat(scores, 1), torch.cat(boxes, 1), (W, H), config.max_detections,
                               config.nms_iou_threshold, confidence_threshold, host)


def candidates_to_batch(flat_score: torch.Tensor, boxes: torch.Tensor, orig_wh, max_detections: int,
                        nms_iou_threshold: float, confidence_threshold: float, host: bool = True) -> DetectionBatch:
    """The decode tail of both single-shot families: the top ``max_detections``
    candidates by score (a stable sort, so ties keep the lower index, as
    ``lax.top_k`` does; zero-padded past the candidates), greedy NMS per
    image, ``score >= threshold`` and ``> 0``, boxes clipped to the original
    image, xywh and the foot point, to host numpy (``host=False``: a dict of
    the four device tensors)."""
    K = max_detections
    W, H = orig_wh_tensors(orig_wh, flat_score.device)
    k = min(K, flat_score.shape[1])
    top_scores, top_idx = torch.sort(flat_score, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    if k < K:
        top_scores = F.pad(top_scores, (0, K - k))
        top_idx = F.pad(top_idx, (0, K - k))
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    keep = nms_mask(top_boxes, top_scores, nms_iou_threshold)
    valid = keep & (top_scores >= confidence_threshold) & (top_scores > 0)
    x0, y0, x1, y1 = (top_boxes[..., i].clamp(min=0.0).minimum(W if i % 2 == 0 else H) for i in range(4))
    xywh = torch.stack([x0, y0, x1 - x0, y1 - y0], dim=-1)
    foot = torch.stack([(x0 + x1) / 2, y1], dim=-1)
    out = {"boxes_xywh": xywh.float(), "scores": top_scores.float(), "valid": valid.bool(), "foot": foot.float()}
    return DetectionBatch(**{k: v.cpu().numpy() for k, v in out.items()}) if host else out
