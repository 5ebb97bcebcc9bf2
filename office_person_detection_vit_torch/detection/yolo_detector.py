"""YOLODetector: YOLOv8, the reference's shipping detector, behind the DETR
detector's interface.

Mirrors ``office_person_detection_vit_tpu/detection/yolo_detector.py:31-81``:
the single-shot facade (``detection/ssd_detector.py``) with the YOLOv8 model
and decode. ``detection.yolo_variant`` (``x`` by default; ``n``/``s``/``m``/
``l``), ``detection.model_size: tiny`` (the test-scale variant in float32),
``detection.dtype`` and ``detection.nms_threshold``. Checkpoints: an
ultralytics ``DetectionModel`` state_dict in a ``.pt``/``.pth``/``.bin``
(converted, ``models/weights.py::convert_yolov8_state_dict``: the
reference's ``best.pt``) or a flat or path-keyed ``.npz``.
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.dto import DetectionBatch
from ..models.yolo import YOLOConfig, YOLOv8, decode_yolo
from .ssd_detector import SSDDetector


class YOLODetector(SSDDetector):
    """Anchor-free YOLOv8 person detector (the DETR detector's API)."""

    checkpoint_suffixes = (".npz", ".pt", ".pth", ".bin")

    def __init__(self, config: Any = None, *, yolo_config: YOLOConfig | None = None):
        super().__init__(config, ss_config=yolo_config)

    @staticmethod
    def _config_from(get) -> YOLOConfig:
        nms = float(get("detection.nms_threshold", 0.45))
        if str(get("detection.model_size", "full")) == "tiny":
            return YOLOConfig.tiny(nms_iou_threshold=nms)
        return YOLOConfig(variant=str(get("detection.yolo_variant", "x")), dtype=str(get("detection.dtype", "bfloat16")),
                          nms_iou_threshold=nms)

    def _make_model(self) -> torch.nn.Module:
        return YOLOv8(self.model_config)

    def _decode(self, out: dict, orig_wh, conf=None, host: bool = True) -> DetectionBatch:
        conf = self.confidence_threshold if conf is None else conf
        return decode_yolo(out, orig_wh, self.input_hw, self.model_config, conf, host)
