"""Training stack: the auction matcher, the DETR set criterion, the
augmentation, the loader and the single-device train step.

Mirrors ``office_person_detection_vit_tpu/training/__init__.py`` without the
YOLO and SSD criteria (ROADMAP A.7) and without ``make_sharded_train_step``
(ROADMAP A.8).
"""

from .augment import AugmentConfig, augment_batch, content_width
from .criterion import CriterionConfig, detr_loss, pack_targets
from .data import COCOBatchLoader, FrameCache, pack_targets_np
from .matcher import auction_assignment, batch_hungarian_match, hungarian_match
from .train_step import TrainState, apply_update, make_optimizer, make_schedule, make_train_step

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
    "make_train_step",
    "pack_targets",
]
