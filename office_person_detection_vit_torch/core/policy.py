"""Typed view of the output flags (reference src/core/policy.py:8-17).

Mirrors ``office_person_detection_vit_tpu/core/policy.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class OutputPolicy:
    save_detection_images: bool = False
    save_tracking_images: bool = False
    save_floormap_images: bool = False
    save_side_by_side_video: bool = False
    debug_mode: bool = False
    cleanup_temp_files: bool = True

    @classmethod
    def from_config(cls, cfg: Any) -> "OutputPolicy":
        return cls(
            save_detection_images=bool(cfg.get("output.save_detection_images", False)),
            save_tracking_images=bool(cfg.get("output.save_tracking_images", False)),
            save_floormap_images=bool(cfg.get("output.save_floormap_images", False)),
            save_side_by_side_video=bool(cfg.get("output.save_side_by_side_video", False)),
            debug_mode=bool(cfg.get("output.debug_mode", False)),
            cleanup_temp_files=bool(cfg.get("output.cleanup_temp_files", True)),
        )
