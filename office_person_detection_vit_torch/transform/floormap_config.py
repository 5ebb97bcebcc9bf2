"""Floormap geometry constants.

A copy of ``office_person_detection_vit_tpu/transform/floormap_config.py``
(host numpy): the floormap image's size, its origin in pixels and the
millimetres of one pixel, read from the ``floormap.*`` keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np


@dataclass(frozen=True)
class FloorMapConfig:
    image_path: str = "data/floormap.png"
    image_width: int = 1878
    image_height: int = 1369
    image_origin_x: float = 7.0
    image_origin_y: float = 9.0
    image_x_mm_per_pixel: float = 28.1926406926406
    image_y_mm_per_pixel: float = 28.241430700447

    @classmethod
    def from_config(cls, cfg: Any) -> "FloorMapConfig":
        return cls(
            image_path=str(cfg.get("floormap.image_path", cls.image_path)),
            image_width=int(cfg.get("floormap.image_width", cls.image_width)),
            image_height=int(cfg.get("floormap.image_height", cls.image_height)),
            image_origin_x=float(cfg.get("floormap.image_origin_x", cls.image_origin_x)),
            image_origin_y=float(cfg.get("floormap.image_origin_y", cls.image_origin_y)),
            image_x_mm_per_pixel=float(cfg.get("floormap.image_x_mm_per_pixel", cls.image_x_mm_per_pixel)),
            image_y_mm_per_pixel=float(cfg.get("floormap.image_y_mm_per_pixel", cls.image_y_mm_per_pixel)),
        )

    @property
    def origin_px(self) -> np.ndarray:
        return np.asarray([self.image_origin_x, self.image_origin_y], np.float32)

    @property
    def mm_per_px(self) -> np.ndarray:
        return np.asarray([self.image_x_mm_per_pixel, self.image_y_mm_per_pixel], np.float32)

    def px_to_mm(self, points_px: np.ndarray) -> np.ndarray:
        return (np.asarray(points_px, np.float32) - self.origin_px) * self.mm_per_px

    def mm_to_px(self, points_mm: np.ndarray) -> np.ndarray:
        return np.asarray(points_mm, np.float32) / self.mm_per_px + self.origin_px

    @property
    def width_mm(self) -> float:
        return self.image_width * self.image_x_mm_per_pixel

    @property
    def height_mm(self) -> float:
        return self.image_height * self.image_y_mm_per_pixel
