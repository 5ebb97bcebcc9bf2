"""Transform-accuracy evaluation (reference
src/evaluation/transform_evaluator.py:75-509).

Mirrors ``office_person_detection_vit_tpu/evaluation/transform_evaluator.py``:
correspondence-point errors of any transformer exposing ``transform_batch``
(homography / PWA / TPS) against floor ground truth: RMSE / mean / max /
per-point errors, the reference's <=10 px RMSE target check
(phase3_high_precision_transform.md:190), side-by-side comparison of
transformers, an error plot (drawn with OpenCV, as the port's charts are),
and leave-one-out cross-validation for interpolating transformers
(reference :447+). The error statistics are one torch reduction over all
points, float32, on the device of the predictions (the host for numpy
input); each transformer predicts on its own device.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..visualization.visualizer import scatter_chart

logger = logging.getLogger(__name__)

RMSE_TARGET_PX = 10.0


def point_errors(predicted, expected) -> dict[str, Any]:
    """(N, 2) vs (N, 2) -> error statistics (one reduction over all points)."""
    pred = torch.as_tensor(predicted if torch.is_tensor(predicted) else np.asarray(predicted), dtype=torch.float32)
    exp = torch.as_tensor(expected if torch.is_tensor(expected) else np.asarray(expected), dtype=torch.float32,
                          device=pred.device)
    err = torch.linalg.norm(pred - exp, dim=-1)
    stats = torch.stack([torch.sqrt(torch.mean(err**2)), err.mean(), err.max(), err.min(), err.std(correction=0)])
    rmse, mean, mx, mn, std = stats.tolist()
    return {"rmse": rmse, "mean_error": mean, "max_error": mx, "min_error": mn, "std_error": std,
            "per_point": err.cpu().tolist()}


class TransformEvaluator:
    def __init__(self, rmse_target: float = RMSE_TARGET_PX):
        self.rmse_target = float(rmse_target)

    @classmethod
    def from_config(cls, cfg: Any) -> "TransformEvaluator":
        """Target from ``calibration.reprojection_error_threshold``
        (reference config default 2.0 px; the docs guide's looser <=10 px is
        this class's constructor default)."""
        return cls(rmse_target=float(cfg.get("calibration.reprojection_error_threshold", RMSE_TARGET_PX)))

    def evaluate(self, transformer: Any, camera_points: np.ndarray, floor_points: np.ndarray) -> dict[str, Any]:
        """``transformer.transform_batch`` on correspondence pairs, with the
        reference's RMSE-target pass/fail (reference :75-81)."""
        predicted = np.asarray(transformer.transform_batch(np.asarray(camera_points, np.float32)))
        stats = point_errors(predicted, np.asarray(floor_points, np.float32))
        stats["num_points"] = int(len(camera_points))
        stats["rmse_target"] = self.rmse_target
        stats["meets_target"] = bool(stats["rmse"] <= self.rmse_target)
        return stats

    def compare(self, transformers: dict[str, Any], camera_points: np.ndarray,
                floor_points: np.ndarray) -> dict[str, dict[str, Any]]:
        """The same correspondences through several transformers (the
        reference's homography-vs-PWA comparison)."""
        return {name: self.evaluate(t, camera_points, floor_points) for name, t in transformers.items()}

    def cross_validate(self, build_fn: Callable[[np.ndarray, np.ndarray], Any], camera_points: np.ndarray,
                       floor_points: np.ndarray) -> dict[str, Any]:
        """Leave-one-out CV for interpolating transformers (reference :447+):
        refit on N-1 correspondences, measure the held-out point's error.
        ``build_fn(cam, floor) -> transformer``. A fold whose refit fails
        (degenerate points) counts as failed, with a NaN error."""
        camera_points = np.asarray(camera_points, np.float32)
        floor_points = np.asarray(floor_points, np.float32)
        n = len(camera_points)
        errors = []
        for i in range(n):
            keep = np.arange(n) != i
            try:
                t = build_fn(camera_points[keep], floor_points[keep])
                pred = np.asarray(t.transform_batch(camera_points[i: i + 1]))[0]
                errors.append(float(np.linalg.norm(pred - floor_points[i])))
            except Exception as e:  # degenerate refit (e.g. collinear points)
                logger.warning("LOO fold %d failed: %s", i, e)
                errors.append(float("nan"))
        arr = np.asarray(errors)
        ok = arr[np.isfinite(arr)]
        return {
            "num_folds": n,
            "failed_folds": int(np.sum(~np.isfinite(arr))),
            "loo_rmse": float(np.sqrt(np.mean(ok**2))) if len(ok) else float("nan"),
            "loo_mean": float(np.mean(ok)) if len(ok) else float("nan"),
            "loo_max": float(np.max(ok)) if len(ok) else float("nan"),
            "per_point": errors,
        }

    def plot_errors(self, camera_points: np.ndarray, floor_points: np.ndarray, predicted: np.ndarray,
                    output_path: str | Path) -> Path:
        """Expected (green dots) vs predicted (red crosses) floor positions
        with grey error segments, y downward as on the floormap; a 9 x 7 in
        figure at 120 dpi, as the JAX package's."""
        floor_points, predicted = np.asarray(floor_points), np.asarray(predicted)
        return scatter_chart([("expected", floor_points, (44, 160, 44), "o"),
                              ("predicted", predicted, (40, 39, 214), "x")],
                             output_path, "Transform reprojection errors", (9, 7),
                             segments=[(floor_points, predicted)], invert_y=True)
