"""Param-driven image preprocessing ops (reference
src/detection/preprocessing.py:14-269).

Host-side OpenCV building blocks — invert, CLAHE, resize, threshold, blur,
unsharp mask, morphology, deskew — plus :func:`apply_pipeline`, which runs
an ordered list of named steps with parameters. A copy of
``office_person_detection_vit_tpu/detection/preprocessing.py``: host code,
byte for byte the same images. These are OCR/offline-prep utilities; the
detector's hot path uses the device preprocessing of ops/preprocessing.py
instead (resize, normalize and pad on the detector's device).
"""

from __future__ import annotations

import logging
from typing import Any, Callable

import cv2
import numpy as np

logger = logging.getLogger(__name__)


def to_grayscale(image: np.ndarray) -> np.ndarray:
    if image.ndim == 3:
        return cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
    return image


def invert(image: np.ndarray) -> np.ndarray:
    """(reference preprocessing.py:14)"""
    return cv2.bitwise_not(image)


def apply_clahe(
    image: np.ndarray, clip_limit: float = 2.0, tile_grid_size: int = 8
) -> np.ndarray:
    """Contrast-limited adaptive histogram equalization (reference :30)."""
    clahe = cv2.createCLAHE(
        clipLimit=clip_limit, tileGridSize=(tile_grid_size, tile_grid_size)
    )
    if image.ndim == 3:
        lab = cv2.cvtColor(image, cv2.COLOR_BGR2LAB)
        lab[..., 0] = clahe.apply(lab[..., 0])
        return cv2.cvtColor(lab, cv2.COLOR_LAB2BGR)
    return clahe.apply(image)


def resize(
    image: np.ndarray,
    width: int | None = None,
    height: int | None = None,
    scale: float | None = None,
    interpolation: int = cv2.INTER_CUBIC,
) -> np.ndarray:
    """Resize by explicit size or scale, keeping aspect if one dim given."""
    h, w = image.shape[:2]
    if scale is not None:
        return cv2.resize(image, (int(w * scale), int(h * scale)), interpolation=interpolation)
    if width is not None and height is not None:
        return cv2.resize(image, (width, height), interpolation=interpolation)
    if width is not None:
        return cv2.resize(image, (width, int(h * width / w)), interpolation=interpolation)
    if height is not None:
        return cv2.resize(image, (int(w * height / h), height), interpolation=interpolation)
    return image


def threshold(
    image: np.ndarray,
    value: int = 0,
    adaptive: bool = False,
    block_size: int = 11,
    c: int = 2,
) -> np.ndarray:
    """Otsu (value=0), fixed, or adaptive-Gaussian binarization."""
    gray = to_grayscale(image)
    if adaptive:
        return cv2.adaptiveThreshold(
            gray, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C, cv2.THRESH_BINARY,
            block_size, c,
        )
    if value == 0:
        _, out = cv2.threshold(gray, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    else:
        _, out = cv2.threshold(gray, value, 255, cv2.THRESH_BINARY)
    return out


def blur(image: np.ndarray, kernel_size: int = 3, gaussian: bool = True) -> np.ndarray:
    k = kernel_size | 1  # must be odd
    if gaussian:
        return cv2.GaussianBlur(image, (k, k), 0)
    return cv2.medianBlur(image, k)


def unsharp_mask(
    image: np.ndarray, kernel_size: int = 5, amount: float = 1.0
) -> np.ndarray:
    """Sharpen: image + amount * (image - blurred)."""
    k = kernel_size | 1
    blurred = cv2.GaussianBlur(image, (k, k), 0)
    return cv2.addWeighted(image, 1.0 + amount, blurred, -amount, 0)


def morphology(
    image: np.ndarray, operation: str = "open", kernel_size: int = 3, iterations: int = 1
) -> np.ndarray:
    """open / close / erode / dilate with a square kernel."""
    kernel = np.ones((kernel_size, kernel_size), np.uint8)
    ops: dict[str, int] = {
        "open": cv2.MORPH_OPEN,
        "close": cv2.MORPH_CLOSE,
        "gradient": cv2.MORPH_GRADIENT,
        "tophat": cv2.MORPH_TOPHAT,
    }
    if operation == "erode":
        return cv2.erode(image, kernel, iterations=iterations)
    if operation == "dilate":
        return cv2.dilate(image, kernel, iterations=iterations)
    if operation not in ops:
        raise ValueError(f"unknown morphology operation: {operation}")
    return cv2.morphologyEx(image, ops[operation], kernel, iterations=iterations)


def deskew(image: np.ndarray, max_angle: float = 15.0) -> np.ndarray:
    """Estimate text skew from the binarized minAreaRect and rotate back
    (reference :200+). No-op when the estimate exceeds max_angle (likely a
    bogus fit) or the image is empty."""
    gray = to_grayscale(image)
    binary = cv2.threshold(gray, 0, 255, cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)[1]
    coords = cv2.findNonZero(binary)
    if coords is None:
        return image
    angle = cv2.minAreaRect(coords)[-1]
    if angle > 45:
        angle -= 90
    if abs(angle) > max_angle or abs(angle) < 1e-3:
        return image
    h, w = image.shape[:2]
    matrix = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
    return cv2.warpAffine(
        image, matrix, (w, h), flags=cv2.INTER_CUBIC, borderMode=cv2.BORDER_REPLICATE
    )


#: step name -> callable (reference apply_pipeline contract, :250-269)
PIPELINE_OPS: dict[str, Callable[..., np.ndarray]] = {
    "grayscale": to_grayscale,
    "invert": invert,
    "clahe": apply_clahe,
    "resize": resize,
    "threshold": threshold,
    "blur": blur,
    "unsharp_mask": unsharp_mask,
    "morphology": morphology,
    "deskew": deskew,
}


def apply_pipeline(
    image: np.ndarray, steps: list[dict[str, Any]]
) -> np.ndarray:
    """Run named steps in order: [{"name": "clahe", "clip_limit": 3.0}, ...].

    Unknown step names raise; per-step parameter errors are logged and the
    step skipped (reference's resilient behavior)."""
    out = image
    for step in steps:
        params = dict(step)
        name = params.pop("name")
        op = PIPELINE_OPS.get(name)
        if op is None:
            raise ValueError(f"unknown preprocessing step: {name}")
        try:
            out = op(out, **params)
        except (cv2.error, TypeError, ValueError) as e:
            logger.warning("preprocessing step %s failed (%s); skipping", name, e)
    return out
