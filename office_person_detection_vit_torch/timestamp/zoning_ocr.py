"""Zoning-feature digit OCR engine — the second dependency-free engine.

The reference's multi-engine consensus assumes 2-3 *independent* OCR
backends (tesseract/easyocr/paddleocr, reference src/timestamp/
ocr_engine.py:32-56). In a hermetic container only the built-in template
engine (template_ocr.py) is real, which reduces consensus to one engine
plus mocks. This engine restores genuine multi-engine consensus offline
with a classifier built on a DIFFERENT recognition principle, so the two
engines have different failure modes:

- template_ocr: per-glyph normalized cross-correlation against a single
  rendered bitmap per class (alignment/resolution sensitive);
- zoning_ocr (this file): classic zoning OCR features — block densities,
  row/column projection profiles, and stroke-crossing counts — classified
  by cosine similarity against per-class centroids averaged over SEVERAL
  font renderings (Hershey simplex/duplex at multiple weights), making it
  robust to stroke-width and font-shape nuisance but blind to fine bitmap
  detail.

Both engines share the Otsu binarization + connected-component
segmentation contract (template_ocr.binarize / _segment), and the whole
charset classification is one (glyphs x features) @ (features x classes)
matmul per ROI.

The port's own copy of ``office_person_detection_vit_tpu/timestamp/zoning_ocr.py`` (host code, unchanged).
"""

from __future__ import annotations

import numpy as np

from .template_ocr import CHARSET, TemplateOCREngine, binarize, spaced_join

#: (font constant name, scale, thickness) variants averaged per class.
_FONT_VARIANTS = (
    ("FONT_HERSHEY_SIMPLEX", 1.7, 3),
    ("FONT_HERSHEY_SIMPLEX", 1.4, 2),
    ("FONT_HERSHEY_DUPLEX", 1.7, 3),
    ("FONT_HERSHEY_DUPLEX", 1.4, 2),
)

_GLYPH_H, _GLYPH_W = 20, 16


def _glyph_features(glyph01: np.ndarray, aspect: float) -> np.ndarray:
    """Binary glyph (20x16, values in {0,1}) -> L2-normalized feature
    vector: 5x4 zoning densities, row/col projection profiles, and
    stroke-crossing counts along 5 horizontal + 3 vertical scanlines —
    the crossings carry the digit topology (e.g. '4' cuts a mid row twice
    where '6' cuts once); halving rather than quartering them keeps their
    magnitude comparable to the density features after L2 normalization."""
    g = glyph01
    zones = g.reshape(5, 4, 4, 4).mean(axis=(1, 3)).reshape(-1)  # 5x4 blocks
    rows = g.mean(axis=1)                                        # 20
    cols = g.mean(axis=0)                                        # 16
    rr = [g[int(_GLYPH_H * f), :] for f in (0.15, 0.35, 0.5, 0.65, 0.85)]
    cc = [g[:, int(_GLYPH_W * f)] for f in (0.25, 0.5, 0.75)]
    crossings = np.asarray(
        [np.abs(np.diff(v)).sum() / 2.0 for v in rr + cc], np.float32
    )
    feat = np.concatenate(
        [zones, rows, cols, crossings, [min(aspect, 2.0) / 2.0]]
    ).astype(np.float32)
    n = float(np.linalg.norm(feat))
    return feat / n if n > 1e-9 else feat


class ZoningOCREngine:
    name = "zoning"

    def __init__(self):
        self._centroids: np.ndarray | None = None  # (classes, features)

    # ------------------------------------------------------------- training
    def _render_centroids(self) -> np.ndarray:
        import cv2

        per_class: list[list[np.ndarray]] = [[] for _ in CHARSET]
        for font_name, scale, thickness in _FONT_VARIANTS:
            font = getattr(cv2, font_name)
            canvas = np.zeros((80, 40 * len(CHARSET) + 40), np.uint8)
            cv2.putText(canvas, CHARSET, (10, 58), font, scale, 255,
                        thickness, cv2.LINE_AA)
            # Train each variant sharp AND defocused: Gaussian blur + Otsu
            # thickens strokes and fuses fine gaps, which shifts the zoning
            # densities and crossing counts; averaging blurred renders into
            # the centroids keeps the features valid on soft footage.
            for sigma in (0.0, 1.5, 3.0):
                blurred = (canvas if sigma == 0.0
                           else cv2.GaussianBlur(canvas, (0, 0), sigma))
                _, binary = cv2.threshold(blurred, 0, 255,
                                          cv2.THRESH_BINARY + cv2.THRESH_OTSU)
                boxes = TemplateOCREngine._segment(binary)
                if len(boxes) != len(CHARSET):  # pragma: no cover - font safety
                    continue
                for i, (x0, y0, x1, y1) in enumerate(boxes):
                    glyph = (binary[y0:y1, x0:x1] > 0).astype(np.float32)
                    glyph = cv2.resize(glyph, (_GLYPH_W, _GLYPH_H))
                    aspect = (x1 - x0) / max(y1 - y0, 1)
                    per_class[i].append(_glyph_features((glyph > 0.5).astype(
                        np.float32), aspect))
        if not all(per_class):  # pragma: no cover - font safety net
            raise RuntimeError("zoning centroid rendering failed")
        cents = np.stack([np.mean(f, axis=0) for f in per_class])
        cents /= np.linalg.norm(cents, axis=1, keepdims=True)
        return cents

    @property
    def centroids(self) -> np.ndarray:
        if self._centroids is None:
            self._centroids = self._render_centroids()
        return self._centroids

    def is_available(self) -> bool:
        try:
            import cv2  # noqa: F401

            return True
        except Exception:  # pragma: no cover
            return False

    # ------------------------------------------------------------------ OCR
    def extract(self, image: np.ndarray) -> tuple[str, float]:
        """Grayscale/BGR ROI -> (text, confidence in [0, 1])."""
        import cv2

        binary = binarize(image)
        boxes = TemplateOCREngine._segment(binary)
        if not boxes:
            return "", 0.0
        feats = []
        for x0, y0, x1, y1 in boxes:
            glyph = (binary[y0:y1, x0:x1] > 0).astype(np.float32)
            glyph = cv2.resize(glyph, (_GLYPH_W, _GLYPH_H))
            feats.append(_glyph_features((glyph > 0.5).astype(np.float32),
                                         (x1 - x0) / max(y1 - y0, 1)))
        sims = np.stack(feats) @ self.centroids.T  # (glyphs, classes)
        order = np.argsort(sims, axis=1)
        best = sims[np.arange(len(boxes)), order[:, -1]]
        second = sims[np.arange(len(boxes)), order[:, -2]]
        # Confidence: cosine to the winner, damped when the margin over the
        # runner-up is thin (ambiguous glyph).
        conf_per = np.clip(best, 0, 1) * np.clip(0.5 + 4.0 * (best - second),
                                                 0.5, 1.0)
        chars = [CHARSET[int(c)] for c in order[:, -1]]
        return spaced_join(boxes, chars), float(np.mean(conf_per))
