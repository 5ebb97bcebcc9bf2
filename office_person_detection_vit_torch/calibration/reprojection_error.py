"""Reprojection-error evaluation (reference src/calibration/reprojection_error.py:35-237).

Mirrors ``office_person_detection_vit_tpu/calibration/reprojection_error.py``:
:meth:`ReprojectionErrorEvaluator.evaluate` holds any transformer's
``transform_batch`` to floor points on the host, and
:meth:`~ReprojectionErrorEvaluator.homography_errors` runs
``ops/geometry.reprojection_errors`` on a device (the card unless asked for
the CPU).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..ops import geometry


class ReprojectionErrorEvaluator:
    def __init__(self, transformer: Any):
        self.transformer = transformer

    def evaluate(self, src_points: np.ndarray, dst_points: np.ndarray) -> dict[str, Any]:
        src = np.atleast_2d(np.asarray(src_points, np.float32))
        dst = np.atleast_2d(np.asarray(dst_points, np.float32))
        pred = self.transformer.transform_batch(src)
        errors = np.linalg.norm(pred - dst, axis=1)
        return {
            "mean_error": float(errors.mean()),
            "max_error": float(errors.max()),
            "min_error": float(errors.min()),
            "std_error": float(errors.std()),
            "rmse": float(np.sqrt(np.mean(errors**2))),
            "per_point_errors": errors.tolist(),
            "num_points": int(len(errors)),
        }

    @staticmethod
    def homography_errors(H: np.ndarray, src: np.ndarray, dst: np.ndarray,
                          device: torch.device | str = "auto") -> np.ndarray:
        """Per-point distance of H(src) from dst, float32 on ``device``."""
        dev = resolve_device(str(device))

        def put(a):
            return torch.tensor(np.atleast_2d(np.asarray(a, np.float32)), device=dev)

        return geometry.reprojection_errors(put(H), put(src), put(dst)).cpu().numpy()
