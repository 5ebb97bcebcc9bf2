"""Piecewise-affine and thin-plate-spline transformer facades.

Mirrors ``office_person_detection_vit_tpu/transform/piecewise_affine.py``:
the correspondence-file constructors, the pickled model (``save``/``load``),
the training error and ``build_transformer``. The fits are host numpy
(``ops/pwa.py``); applying them runs on the transformer's device
(``detection.device``; the default ``"auto"`` is the card, ``"cpu"`` the
CPU).

A pickled PWA model holds a ``FloorMapConfig``. One saved by the JAX package
names the JAX package's class, so a plain ``pickle.load`` would import the
JAX package. :func:`_load_model_state` maps that class, and the port's own,
to the port's ``FloorMapConfig``, allows numpy's array reconstruction and a
few builtins, and refuses every other global.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..core.dto import Detection
from ..device import config_device, resolve_device
from ..ops import pwa as pwa_ops
from .common import apply_floor_transform
from .floormap_config import FloorMapConfig

_FLOORMAP_CLASSES = {
    ("office_person_detection_vit_tpu.transform.floormap_config", "FloorMapConfig"),
    ("office_person_detection_vit_torch.transform.floormap_config", "FloorMapConfig"),
}
_NUMPY_GLOBALS = {
    (module, name)
    for core in ("numpy.core", "numpy._core")
    for module, name in ((f"{core}.multiarray", "_reconstruct"), (f"{core}.multiarray", "scalar"),
                         (f"{core}.numeric", "_frombuffer"))
} | {("numpy", "ndarray"), ("numpy", "dtype")}
_BUILTINS = {"bytearray", "bytes", "complex", "dict", "float", "frozenset", "int", "list", "set", "str", "tuple"}


class _ModelUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _FLOORMAP_CLASSES:
            return FloorMapConfig
        if (module, name) in _NUMPY_GLOBALS or (module == "builtins" and name in _BUILTINS):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"a PWA model file may not name {module}.{name}")


def _load_model_state(path: str | Path) -> dict:
    with open(path, "rb") as f:
        return _ModelUnpickler(f).load()


def load_correspondences(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """A correspondence JSON -> (camera, floormap) points, float64: either
    ``{"points": [{"camera": [x, y], "floormap": [x, y]}, ...]}`` or
    ``{"camera": [[x, y], ...], "floormap": [[x, y], ...]}``."""
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    if "points" in data:
        src = np.asarray([p["camera"] for p in data["points"]], np.float64)
        dst = np.asarray([p["floormap"] for p in data["points"]], np.float64)
    else:
        src = np.asarray(data["camera"], np.float64)
        dst = np.asarray(data["floormap"], np.float64)
    return src, dst


def _training_error(pred: np.ndarray, dst: np.ndarray) -> dict[str, float]:
    err = np.linalg.norm(pred - dst, axis=1)
    return {"rmse": float(np.sqrt(np.mean(err**2))), "max_error": float(err.max()), "mean_error": float(err.mean())}


class PiecewiseAffineTransformer:
    method = "piecewise_affine"

    def __init__(self, src_points: np.ndarray, dst_points: np.ndarray, floormap: FloorMapConfig | None = None,
                 undistorter=None, device: torch.device | str = "auto"):
        self.device = resolve_device(str(device))
        self.undistorter = undistorter
        if undistorter is not None:
            src_points = undistorter.undistort_points(np.asarray(src_points, np.float64))
        self.model = pwa_ops.fit_pwa(src_points, dst_points)
        self.floormap = floormap or FloorMapConfig()
        self._tri, self._aff, self._cen = (
            torch.from_numpy(a).to(self.device) for a in (self.model.triangles, self.model.affines, self.model.centroids)
        )

    @classmethod
    def from_correspondence_file(cls, path: str | Path, floormap: FloorMapConfig | None = None, undistorter=None,
                                 device: torch.device | str = "auto") -> "PiecewiseAffineTransformer":
        src, dst = load_correspondences(path)
        return cls(src, dst, floormap, undistorter, device)

    @classmethod
    def load(cls, path: str | Path, undistorter=None, device: torch.device | str = "auto") -> "PiecewiseAffineTransformer":
        """The saved src_points are already undistorted (they are the fit's
        inputs), so the model is rebuilt without undistorting them again and
        the undistorter is attached for the query points."""
        state = _load_model_state(path)
        t = cls(state["src_points"], state["dst_points"], state.get("floormap"), device=device)
        t.undistorter = undistorter
        return t

    def save(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump({"src_points": self.model.src_points, "dst_points": self.model.dst_points,
                         "floormap": self.floormap}, f)

    def transform_tensor(self, points: torch.Tensor) -> torch.Tensor:
        """(N, 2) float32 camera pixels on the device -> floormap pixels
        (undistorted first where the transformer has an undistorter)."""
        if self.undistorter is not None:
            points = self.undistorter.undistort_tensor(points)
        return self._transform_model_space(points)

    def _transform_model_space(self, points: torch.Tensor) -> torch.Tensor:
        """Points already in the fit's (undistorted) space."""
        return pwa_ops.pwa_transform(points, self._tri, self._aff, self._cen)

    def transform_batch(self, points: np.ndarray) -> np.ndarray:
        pts = torch.tensor(np.atleast_2d(np.asarray(points, np.float32)), device=self.device)
        return self.transform_tensor(pts).cpu().numpy()

    def transform_pixel(self, x: float, y: float) -> tuple[float, float]:
        out = self.transform_batch(np.asarray([[x, y]], np.float32))[0]
        return float(out[0]), float(out[1])

    def transform_detections(self, dets: list[Detection]) -> list[Detection]:
        return apply_floor_transform(self, dets)

    def training_error(self) -> dict[str, float]:
        """RMSE, max and mean over the correspondences, which are already in
        the fit's space (undistorting them again would be wrong)."""
        src = torch.from_numpy(self.model.src_points).to(self.device)
        return _training_error(self._transform_model_space(src).cpu().numpy(), self.model.dst_points)

    def get_info(self) -> dict:
        return {"method": self.method, "num_points": self.model.num_points,
                "num_triangles": self.model.num_triangles, "training_error": self.training_error()}


class ThinPlateSplineTransformer:
    method = "thin_plate_spline"

    def __init__(self, src_points: np.ndarray, dst_points: np.ndarray, floormap: FloorMapConfig | None = None,
                 reg: float = 0.0, device: torch.device | str = "auto"):
        self.device = resolve_device(str(device))
        self.model = pwa_ops.fit_tps(src_points, dst_points, reg=reg)
        self.floormap = floormap or FloorMapConfig()
        m = self.model
        self._args = tuple(torch.from_numpy(a).to(self.device) for a in (m.control, m.w, m.a, m.offset))
        self._scale = torch.tensor(m.scale, dtype=torch.float32, device=self.device)
        self._src = np.asarray(src_points, np.float64)
        self._dst = np.asarray(dst_points, np.float64)

    @classmethod
    def from_correspondence_file(cls, path: str | Path, floormap: FloorMapConfig | None = None,
                                 device: torch.device | str = "auto") -> "ThinPlateSplineTransformer":
        src, dst = load_correspondences(path)
        return cls(src, dst, floormap, device=device)

    def transform_tensor(self, points: torch.Tensor) -> torch.Tensor:
        """(N, 2) float32 camera pixels on the device -> floormap pixels."""
        return pwa_ops.tps_transform(points, *self._args, self._scale)

    def transform_batch(self, points: np.ndarray) -> np.ndarray:
        pts = torch.tensor(np.atleast_2d(np.asarray(points, np.float32)), device=self.device)
        return self.transform_tensor(pts).cpu().numpy()

    def transform_pixel(self, x: float, y: float) -> tuple[float, float]:
        out = self.transform_batch(np.asarray([[x, y]], np.float32))[0]
        return float(out[0]), float(out[1])

    def transform_detections(self, dets: list[Detection]) -> list[Detection]:
        return apply_floor_transform(self, dets)

    def training_error(self) -> dict[str, float]:
        return _training_error(self.transform_batch(self._src.astype(np.float32)), self._dst)

    def get_info(self) -> dict:
        return {"method": self.method, "num_points": int(len(self._src)), "training_error": self.training_error()}


def build_transformer(cfg: Any, undistorter=None):
    """The transformer ``transform.method`` names, on ``detection.device``:
    homography from ``homography.matrix``; piecewise_affine from
    ``transform.model_path`` where it exists, else fitted on
    ``calibration.correspondence_file`` (and saved to ``transform.model_path``
    when that is set); thin_plate_spline from the correspondence file. The
    undistorter applies to piecewise_affine only, as in the JAX package."""
    method = cfg.get("transform.method", "homography")
    floormap = FloorMapConfig.from_config(cfg)
    device = config_device(cfg)
    if method == "homography":
        from .homography import HomographyTransformer

        return HomographyTransformer.from_config(cfg)
    model_path = cfg.get("transform.model_path")
    corr = cfg.get("calibration.correspondence_file")
    if method == "piecewise_affine":
        if model_path and Path(str(model_path)).exists():
            loaded = PiecewiseAffineTransformer.load(model_path, undistorter=undistorter, device=device)
            loaded.floormap = floormap
            return loaded
        if corr and Path(str(corr)).exists():
            t = PiecewiseAffineTransformer.from_correspondence_file(corr, floormap, undistorter, device)
            if model_path:
                t.save(model_path)
            return t
        raise FileNotFoundError("piecewise_affine needs transform.model_path or calibration.correspondence_file")
    if method == "thin_plate_spline":
        if corr and Path(str(corr)).exists():
            return ThinPlateSplineTransformer.from_correspondence_file(corr, floormap, device)
        raise FileNotFoundError("thin_plate_spline needs calibration.correspondence_file")
    raise ValueError(f"unknown transform method: {method}")
