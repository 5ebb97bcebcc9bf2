"""Chessboard camera calibration (reference src/calibration/camera_calibrator.py:36-92).

Mirrors ``office_person_detection_vit_tpu/calibration/camera_calibrator.py``:
a host-side cv2 tool that produces the port's ``DistortionParams``, which
``LensDistortionCorrector`` applies on its device.
"""

from __future__ import annotations

import logging
import numpy as np

from .lens_distortion import DistortionParams

logger = logging.getLogger(__name__)


class CameraCalibrator:
    def __init__(self, board_size: tuple[int, int] = (9, 6), square_size: float = 25.0):
        self.board_size = board_size
        self.square_size = square_size
        self.object_points: list[np.ndarray] = []
        self.image_points: list[np.ndarray] = []
        self.image_size: tuple[int, int] | None = None

    def add_image(self, image: np.ndarray) -> bool:
        import cv2

        gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY) if image.ndim == 3 else image
        found, corners = cv2.findChessboardCorners(gray, self.board_size, None)
        if not found:
            return False
        corners = cv2.cornerSubPix(
            gray, corners, (11, 11), (-1, -1),
            (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_COUNT, 30, 0.001),
        )
        objp = np.zeros((self.board_size[0] * self.board_size[1], 3), np.float32)
        objp[:, :2] = np.mgrid[0 : self.board_size[0], 0 : self.board_size[1]].T.reshape(-1, 2)
        objp *= self.square_size
        self.object_points.append(objp)
        self.image_points.append(corners)
        self.image_size = gray.shape[::-1]
        return True

    def calibrate(self) -> tuple[DistortionParams, float]:
        import cv2

        if len(self.object_points) < 3:
            raise ValueError("need >= 3 chessboard views")
        rms, K, dist, _, _ = cv2.calibrateCamera(
            self.object_points, self.image_points, self.image_size, None, None
        )
        d = dist.reshape(-1)
        params = DistortionParams(
            k1=float(d[0]), k2=float(d[1]), p1=float(d[2]), p2=float(d[3]),
            k3=float(d[4]) if len(d) > 4 else 0.0,
            focal_length_x=float(K[0, 0]), focal_length_y=float(K[1, 1]),
            center_x=float(K[0, 2]), center_y=float(K[1, 2]),
            image_width=self.image_size[0], image_height=self.image_size[1],
        )
        logger.info("calibration RMS reprojection error: %.3f px", rms)
        return params, float(rms)
