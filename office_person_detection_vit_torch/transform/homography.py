"""Homography transformer facade.

Mirrors ``office_person_detection_vit_tpu/transform/homography.py``: a host
API over ``ops/geometry.py`` on one device (``detection.device``; the
default ``"auto"`` is the card, ``"cpu"`` the CPU). The batched paths take
every point of a run in one device call; :meth:`transform_tensor` keeps the
points on the device for the transform phase's single pass.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.dto import Detection
from ..device import config_device, resolve_device
from ..ops import geometry
from .common import apply_floor_transform
from .floormap_config import FloorMapConfig


class HomographyTransformer:
    method = "homography"

    def __init__(self, matrix: np.ndarray, floormap: FloorMapConfig | None = None,
                 device: torch.device | str = "auto"):
        matrix = np.asarray(matrix, np.float64)
        geometry.validate_homography(matrix)
        self.H = matrix
        self.device = resolve_device(str(device))
        self._H_dev = torch.tensor(matrix, dtype=torch.float32, device=self.device)
        self.floormap = floormap or FloorMapConfig()

    @classmethod
    def from_config(cls, cfg: Any) -> "HomographyTransformer":
        m = cfg.get("homography.matrix")
        if m is None:
            raise ValueError("homography.matrix missing from config")
        return cls(np.asarray(m, np.float64), FloorMapConfig.from_config(cfg), config_device(cfg))

    @staticmethod
    def get_foot_point(bbox: tuple[float, float, float, float]) -> tuple[float, float]:
        """Bottom-center of an xywh bbox."""
        x, y, w, h = bbox
        return (x + w / 2.0, y + h)

    def transform_tensor(self, points: torch.Tensor) -> torch.Tensor:
        """(N, 2) float32 camera pixels on the device -> floormap pixels."""
        return geometry.homography_transform(self._H_dev, points)

    def transform_batch(self, points: np.ndarray) -> np.ndarray:
        """(N, 2) camera pixels -> (N, 2) floormap pixels (host numpy)."""
        pts = torch.tensor(np.atleast_2d(np.asarray(points, np.float32)), device=self.device)
        return self.transform_tensor(pts).cpu().numpy()

    def transform_pixel(self, x: float, y: float) -> tuple[float, float]:
        out = self.transform_batch(np.asarray([[x, y]], np.float32))[0]
        return float(out[0]), float(out[1])

    def transform_detection(self, det: Detection) -> Detection:
        return self.transform_detections([det])[0]

    def transform_detections(self, dets: list[Detection]) -> list[Detection]:
        """Every detection's floor coordinates in one device call."""
        return apply_floor_transform(self, dets)

    def is_in_bounds(self, floor_px: np.ndarray) -> np.ndarray:
        pts = torch.tensor(np.atleast_2d(np.asarray(floor_px, np.float32)), device=self.device)
        return geometry.in_bounds_mask(pts, float(self.floormap.image_width),
                                       float(self.floormap.image_height)).cpu().numpy()

    def get_info(self) -> dict:
        return {"method": self.method, "num_points": 0}
