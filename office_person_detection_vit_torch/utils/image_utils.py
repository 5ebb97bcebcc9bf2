"""Annotated detection frames (host OpenCV).

The detection-image part of ``office_person_detection_vit_tpu/utils/image_utils.py``:
``draw_detections``, ``save_detection_image`` and
``save_tracked_detection_image`` with the JAX package's
colours, labels and label placement. OpenCV is imported inside each
function, so the module imports where there is no ``cv2``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from ..core.dto import Detection

_DETECTION_COLOR = (0, 200, 0)  # BGR green
_LABEL_TEXT = (255, 255, 255)


def track_id_color(track_id: int) -> tuple[int, int, int]:
    """Deterministic, well-spread BGR colour of a track id (golden-angle hue)."""
    import cv2

    hue = int((track_id * 137.508) % 180)  # OpenCV hue range is [0, 180)
    b, g, r = cv2.cvtColor(np.array([[[hue, 220, 255]]], np.uint8), cv2.COLOR_HSV2BGR)[0, 0]
    return int(b), int(g), int(r)


def _draw_label(img: np.ndarray, text: str, x: int, y: int, color: tuple[int, int, int],
                used_rows: list[tuple[int, int, int]]) -> None:
    """A filled label box above (x, y), moved down where it would overlap a
    label placed before it."""
    import cv2

    (tw, th), baseline = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
    ty = max(th + baseline, y)
    for ux, uw, uy in used_rows:
        if abs(uy - ty) < th + baseline + 2 and ux < x + tw and x < ux + uw:
            ty = uy + th + baseline + 4
    used_rows.append((x, tw, ty))
    cv2.rectangle(img, (x, ty - th - baseline), (x + tw + 4, ty + 2), color, -1)
    cv2.putText(img, text, (x + 2, ty - baseline // 2), cv2.FONT_HERSHEY_SIMPLEX, 0.5, _LABEL_TEXT, 1, cv2.LINE_AA)


def draw_detections(frame: np.ndarray, detections: Sequence[Detection], *, draw_track_ids: bool = False,
                    draw_confidence: bool = True, draw_foot_point: bool = True) -> np.ndarray:
    """A copy of the frame with boxes, labels and foot points drawn."""
    import cv2

    img = frame.copy()
    used_rows: list[tuple[int, int, int]] = []
    for det in detections:
        x, y, w, h = (int(round(v)) for v in det.bbox)
        tracked = draw_track_ids and det.track_id is not None
        color = track_id_color(det.track_id) if tracked else _DETECTION_COLOR
        cv2.rectangle(img, (x, y), (x + w, y + h), color, 2)
        parts = [f"ID{det.track_id}"] if tracked else []
        if draw_confidence:
            parts.append(f"{det.confidence:.2f}")
        if parts:
            _draw_label(img, " ".join(parts), x, y, color, used_rows)
        if draw_foot_point and det.foot_point is not None:
            fx, fy = (int(round(v)) for v in det.foot_point)
            cv2.circle(img, (fx, fy), 4, color, -1)
    return img


def save_detection_image(frame: np.ndarray, detections: Sequence[Detection], output_path: str | Path,
                         **kwargs) -> Path:
    """Annotate a frame and write it."""
    import cv2

    out = Path(output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(out), draw_detections(frame, detections, **kwargs))
    return out


def save_tracked_detection_image(frame: np.ndarray, detections: Sequence[Detection], output_path: str | Path) -> Path:
    """A tracked frame: each track id's own colour and an ID label."""
    return save_detection_image(frame, detections, output_path, draw_track_ids=True)
