"""Training stack: the auction matcher, the DETR set criterion, the
single-shot (FCOS) and YOLOv8 criteria, the augmentation, the loader, and
the one-device and sharded train steps.

Mirrors ``office_person_detection_vit_tpu/training/__init__.py`` and exports
the same names.
"""

from .augment import AugmentConfig, augment_batch, content_width
from .criterion import CriterionConfig, detr_loss, pack_targets
from .data import COCOBatchLoader, FrameCache, pack_targets_np
from .matcher import auction_assignment, batch_hungarian_match, hungarian_match
from .ssd_criterion import SSDCriterionConfig, make_ssd_train_step, ssd_loss
from .train_step import (TrainState, apply_update, make_optimizer, make_schedule, make_sharded_train_step,
                         make_train_step)
from .yolo_criterion import YOLOCriterionConfig, make_yolo_sharded_train_step, make_yolo_train_step, yolo_loss

__all__ = [
    "AugmentConfig",
    "COCOBatchLoader",
    "CriterionConfig",
    "FrameCache",
    "pack_targets_np",
    "TrainState",
    "apply_update",
    "augment_batch",
    "content_width",
    "make_schedule",
    "auction_assignment",
    "batch_hungarian_match",
    "detr_loss",
    "hungarian_match",
    "make_optimizer",
    "make_sharded_train_step",
    "make_train_step",
    "SSDCriterionConfig",
    "make_ssd_train_step",
    "pack_targets",
    "ssd_loss",
    "YOLOCriterionConfig",
    "make_yolo_sharded_train_step",
    "make_yolo_train_step",
    "yolo_loss",
]
