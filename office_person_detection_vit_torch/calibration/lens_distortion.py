"""Lens distortion correction (the Brown radial + tangential model).

Mirrors ``office_person_detection_vit_tpu/calibration/lens_distortion.py``:
``DistortionParams.from_config`` (the flat ``transform.lens_distortion.*``
keys, or the ``calibration.distortion`` / ``calibration.intrinsics`` layout)
and ``LensDistortionCorrector``, whose point methods run
``ops/geometry.py`` on the corrector's device. ``undistort_image`` needs
OpenCV, which is imported only when it is called.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..ops import geometry


@dataclass(frozen=True)
class DistortionParams:
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    focal_length_x: float = 1250.0
    focal_length_y: float = 1250.0
    center_x: float = 640.0
    center_y: float = 360.0
    image_width: int = 1280
    image_height: int = 720

    @classmethod
    def from_config(cls, cfg: Any, prefix: str = "transform.lens_distortion") -> "DistortionParams":
        """The flat ``<prefix>.*`` keys; where their coefficients are all zero
        and ``calibration.distortion`` is set, the coefficients come from
        there and the intrinsics from ``calibration.intrinsics`` (falling back
        to the flat ones)."""
        g = lambda k, d: cfg.get(f"{prefix}.{k}", d)  # noqa: E731
        flat = cls(
            k1=float(g("k1", 0.0)), k2=float(g("k2", 0.0)), k3=float(g("k3", 0.0)),
            p1=float(g("p1", 0.0)), p2=float(g("p2", 0.0)),
            focal_length_x=float(g("focal_length_x", 1250.0)),
            focal_length_y=float(g("focal_length_y", 1250.0)),
            center_x=float(g("center_x", 640.0)), center_y=float(g("center_y", 360.0)),
            image_width=int(g("image_width", 1280)), image_height=int(g("image_height", 720)),
        )
        flat_coeffs_set = any((flat.k1, flat.k2, flat.k3, flat.p1, flat.p2))
        if not flat_coeffs_set and cfg.get("calibration.distortion") is not None:
            d = lambda k, v: cfg.get(f"calibration.distortion.{k}", v)  # noqa: E731
            i = lambda k, v: cfg.get(f"calibration.intrinsics.{k}", v)  # noqa: E731
            return cls(
                k1=float(d("k1", 0.0)), k2=float(d("k2", 0.0)), k3=float(d("k3", 0.0)),
                p1=float(d("p1", 0.0)), p2=float(d("p2", 0.0)),
                focal_length_x=float(i("focal_length_x", flat.focal_length_x)),
                focal_length_y=float(i("focal_length_y", flat.focal_length_y)),
                center_x=float(i("principal_point_x", flat.center_x)),
                center_y=float(i("principal_point_y", flat.center_y)),
                image_width=int(i("image_width", flat.image_width)),
                image_height=int(i("image_height", flat.image_height)),
            )
        return flat

    @property
    def camera_matrix(self) -> np.ndarray:
        return np.asarray(
            [[self.focal_length_x, 0.0, self.center_x], [0.0, self.focal_length_y, self.center_y], [0.0, 0.0, 1.0]],
            np.float64,
        )

    @property
    def dist_coeffs(self) -> np.ndarray:
        return np.asarray([self.k1, self.k2, self.p1, self.p2, self.k3], np.float64)

    @property
    def is_identity(self) -> bool:
        return not any([self.k1, self.k2, self.k3, self.p1, self.p2])


class LensDistortionCorrector:
    """Point (un)distortion on ``device`` (``detection.device`` values: the
    default ``"auto"`` is the card, ``"cpu"`` the CPU)."""

    #: Fixed-point steps of the point undistortion.
    UNDISTORT_ITERS = 20

    def __init__(self, params: DistortionParams, device: torch.device | str = "auto"):
        self.params = params
        self.device = resolve_device(str(device))
        self._K = torch.tensor(params.camera_matrix, dtype=torch.float32, device=self.device)
        self._d = torch.tensor(params.dist_coeffs, dtype=torch.float32, device=self.device)

    @classmethod
    def from_config(cls, cfg: Any, device: torch.device | str = "auto") -> "LensDistortionCorrector":
        return cls(DistortionParams.from_config(cfg), device)

    def undistort_tensor(self, points: torch.Tensor) -> torch.Tensor:
        """(N, 2) float32 distorted pixels on the device -> undistorted."""
        if self.params.is_identity:
            return points
        return geometry.undistort_points(points, self._K, self._d, num_iters=self.UNDISTORT_ITERS)

    def _host(self, fn, points) -> np.ndarray:
        pts = np.atleast_2d(np.asarray(points, np.float32))
        if self.params.is_identity:
            return pts
        return fn(torch.from_numpy(pts).to(self.device)).cpu().numpy()

    def undistort_point(self, x: float, y: float) -> tuple[float, float]:
        out = self.undistort_points(np.asarray([[x, y]], np.float32))[0]
        return float(out[0]), float(out[1])

    def undistort_points(self, points: np.ndarray) -> np.ndarray:
        return self._host(self.undistort_tensor, points)

    def distort_points(self, points: np.ndarray) -> np.ndarray:
        return self._host(lambda p: geometry.distort_points(p, self._K, self._d), points)

    def undistort_image(self, image: np.ndarray) -> np.ndarray:
        """Whole-image undistortion (host OpenCV, imported here)."""
        import cv2

        return cv2.undistort(image, self.params.camera_matrix, self.params.dist_coeffs)
