"""Built-in template-matching digit OCR engine (no external dependencies).

The reference relies on tesseract/easyocr/paddleocr binaries
(src/timestamp/ocr_engine.py:32-56), none of which ship in a hermetic
container. This engine recognizes the timestamp charset (digits, '/', ':',
space) by normalized cross-correlation against glyph templates rendered with
the same Hershey font family burned into the synthetic test videos. It slots
into MultiEngineOCR like any other engine.

The port's own copy of ``office_person_detection_vit_tpu/timestamp/template_ocr.py`` (host code; only this docstring differs).
"""

from __future__ import annotations

import numpy as np

CHARSET = "0123456789/:"

#: Template banks: (cv2 font constant name, scale, thickness) for every
#: Hershey face the charset renders and segments cleanly in, at two stroke
#: weights where useful. Recognition scores each bank over the whole ROI and
#: reads with the best one, so font drift in the source video degrades into
#: a bank switch instead of a mis-read (reference runs tesseract, which is
#: font-agnostic by training — reference src/timestamp/ocr_engine.py:32-56).
#: Entries are (face, scale, thickness[, blur sigma]) — sigma'd banks model
#: defocused footage, where blur + Otsu thickens strokes past what any sharp
#: bank matches.
_FONT_BANKS = (
    ("FONT_HERSHEY_SIMPLEX", 1.7, 3),
    ("FONT_HERSHEY_SIMPLEX", 1.4, 2),
    ("FONT_HERSHEY_SIMPLEX", 1.7, 3, 2.5),
    ("FONT_HERSHEY_PLAIN", 2.8, 2),
    ("FONT_HERSHEY_DUPLEX", 1.7, 3),
    ("FONT_HERSHEY_DUPLEX", 1.4, 2),
    ("FONT_HERSHEY_DUPLEX", 1.7, 3, 2.5),
    ("FONT_HERSHEY_COMPLEX", 1.7, 3),
    ("FONT_HERSHEY_COMPLEX", 1.4, 2),
    ("FONT_HERSHEY_TRIPLEX", 1.7, 3),
    ("FONT_HERSHEY_COMPLEX_SMALL", 2.2, 2),
    ("FONT_HERSHEY_SCRIPT_SIMPLEX", 1.7, 2),
    ("FONT_HERSHEY_SCRIPT_COMPLEX", 1.7, 2),
    # Non-Hershey family: the 5x7 dot-matrix bitmap font (bitmap_font.py).
    # Security-camera overlays are frequently dot-matrix; this also breaks
    # the Hershey monoculture of the synthetic robustness evidence.
    ("BITMAP_5X7", 5, 0),
)


def spaced_join(boxes: list[tuple[int, int, int, int]],
                chars: list[str]) -> str:
    """Join per-glyph characters, inserting a space wherever the horizontal
    gap between adjacent boxes exceeds 0.9x the median glyph width (shared
    by both offline engines so their consensus strings stay comparable)."""
    widths = [x1 - x0 for x0, _, x1, _ in boxes]
    median_w = float(np.median(widths)) if widths else 1.0
    out: list[str] = []
    prev_x1 = None
    for (x0, _, x1, _), ch in zip(boxes, chars):
        if prev_x1 is not None and x0 - prev_x1 > 0.9 * median_w:
            out.append(" ")
        prev_x1 = x1
        out.append(ch)
    return "".join(out)


def binarize(image: np.ndarray) -> np.ndarray:
    """Grayscale/BGR ROI -> Otsu binary with text-bright polarity
    (burned-in timestamps are white-ish). Shared by the offline engines."""
    import cv2

    if image.ndim == 3:
        image = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
    _, binary = cv2.threshold(image, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    if binary.mean() > 127:  # inverted polarity
        binary = 255 - binary
    return binary


class TemplateOCREngine:
    name = "template"

    def __init__(self, glyph_h: int = 32, glyph_w: int = 20,
                 font_banks: tuple = _FONT_BANKS):
        self.glyph_h = glyph_h
        self.glyph_w = glyph_w
        self.font_banks = font_banks
        self._banks: list[tuple[str, dict[str, np.ndarray]]] | None = None

    def _render_templates(self, font_name: str, scale: float,
                          thickness: int,
                          sigma: float = 0.0) -> dict[str, np.ndarray] | None:
        """Render the whole charset as one string and segment it with the
        same pipeline used at recognition time, so every template glyph is
        clipped to the common text band exactly like a real observation
        (otherwise band-relative glyphs such as ':' mismatch). Returns None
        when the face doesn't segment into exactly one box per char (e.g.
        script faces whose glyphs touch) — that bank is skipped."""
        import cv2

        if font_name == "BITMAP_5X7":
            from .bitmap_font import render_text

            canvas = render_text(CHARSET, scale=int(scale), fg=255, bg=0,
                                 pad=10, tracking=2)
        else:
            canvas = np.zeros((80, 40 * len(CHARSET) + 40), np.uint8)
            cv2.putText(
                canvas, CHARSET, (10, 58), getattr(cv2, font_name), scale,
                255, thickness, cv2.LINE_AA,
            )
        if sigma > 0:
            canvas = cv2.GaussianBlur(canvas, (0, 0), sigma)
            _, binary = cv2.threshold(canvas, 0, 255,
                                      cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        else:
            _, binary = cv2.threshold(canvas, 32, 255, cv2.THRESH_BINARY)
        boxes = self._segment(binary)
        if len(boxes) != len(CHARSET):
            return None
        out = {}
        for ch, (x0, y0, x1, y1) in zip(CHARSET, boxes):
            glyph = binary[y0:y1, x0:x1].astype(np.float32)
            out[ch] = cv2.resize(glyph, (self.glyph_w, self.glyph_h))
        return out

    @property
    def banks(self) -> list[tuple[str, dict[str, np.ndarray]]]:
        """[(bank label, char -> template)] for every face that rendered."""
        if self._banks is None:
            banks = []
            for spec in self.font_banks:
                font_name, scale, thickness = spec[:3]
                sigma = spec[3] if len(spec) > 3 else 0.0
                tmpl = self._render_templates(font_name, scale, thickness,
                                              sigma)
                if tmpl is not None:
                    label = f"{font_name}@{scale}x{thickness}"
                    if sigma:
                        label += f"~{sigma}"
                    banks.append((label, tmpl))
            if not banks:  # pragma: no cover - font safety net
                raise RuntimeError("no template font bank rendered cleanly")
            self._banks = banks
        return self._banks

    @property
    def templates(self) -> dict[str, np.ndarray]:
        """Primary (Hershey simplex) bank — kept for back-compat."""
        return self.banks[0][1]

    def is_available(self) -> bool:
        try:
            import cv2  # noqa: F401

            return True
        except Exception:  # pragma: no cover
            return False

    # ------------------------------------------------------------------ OCR
    def extract(self, image: np.ndarray) -> tuple[str, float]:
        """Grayscale ROI -> (text, confidence in [0, 1])."""
        import cv2

        binary = binarize(image)
        boxes = self._segment(binary)
        if not boxes:
            return "", 0.0
        glyphs = []
        for x0, y0, x1, y1 in boxes:
            glyph = binary[y0:y1, x0:x1].astype(np.float32)
            glyphs.append(cv2.resize(glyph, (self.glyph_w, self.glyph_h)))
        # One font per ROI: score each bank over ALL glyphs and read with
        # the best-explaining bank (per-glyph bank mixing would let look-
        # alike glyphs from different faces beat a consistent reading).
        best_chars: list[str] = []
        best_scores: list[float] = []
        best_mean = -2.0
        for _, templates in self.banks:
            chars: list[str] = []
            scores: list[float] = []
            for glyph in glyphs:
                best_ch, best_score = "", -1.0
                for ch, tmpl in templates.items():
                    score = self._ncc(glyph, tmpl)
                    if score > best_score:
                        best_ch, best_score = ch, score
                chars.append(best_ch)
                scores.append(max(best_score, 0.0))
            mean = float(np.mean(scores)) if scores else 0.0
            if mean > best_mean:
                best_mean, best_chars, best_scores = mean, chars, scores
        text = spaced_join(boxes, best_chars)
        conf = float(np.mean(best_scores)) if best_scores else 0.0
        return text, conf

    @staticmethod
    def _ncc(a: np.ndarray, b: np.ndarray) -> float:
        a = a - a.mean()
        b = b - b.mean()
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        if denom < 1e-9:
            return 0.0
        return float((a * b).sum() / denom)

    @staticmethod
    def _segment(binary: np.ndarray) -> list[tuple[int, int, int, int]]:
        """Connected-component char boxes, left-to-right.

        Components whose x-ranges overlap are merged into one glyph box —
        this reassembles multi-part glyphs, most importantly the two dots of
        ':' which would otherwise be dropped as specks.
        """
        import cv2

        n, _, stats, _ = cv2.connectedComponentsWithStats(binary, connectivity=8)
        raw = []
        for i in range(1, n):
            x, y, w, h, area = stats[i]
            if area < 3:
                continue
            raw.append((int(x), int(y), int(x + w), int(y + h), int(area)))
        raw.sort(key=lambda b: b[0])

        merged: list[list[int]] = []
        for x0, y0, x1, y1, area in raw:
            if merged and x0 < merged[-1][2] - 1:  # x-overlap -> same glyph
                m = merged[-1]
                m[0] = min(m[0], x0)
                m[1] = min(m[1], y0)
                m[2] = max(m[2], x1)
                m[3] = max(m[3], y1)
                m[4] += area
            else:
                merged.append([x0, y0, x1, y1, area])

        h_img = binary.shape[0]
        boxes = [
            (m[0], m[1], m[2], m[3])
            for m in merged
            if m[4] >= 8 and (m[3] - m[1]) >= h_img * 0.15
        ]
        if not boxes:
            return boxes
        # Common baseline: clip each box vertically to the union band so
        # noise specks don't skew glyph normalization.
        y0 = min(b[1] for b in boxes)
        y1 = max(b[3] for b in boxes)
        boxes = [(x0, y0, x1, y1) for x0, _, x1, _ in boxes]
        return TemplateOCREngine._split_touching(binary, boxes)

    @staticmethod
    def _split_touching(
        binary: np.ndarray, boxes: list[tuple[int, int, int, int]]
    ) -> list[tuple[int, int, int, int]]:
        """Glyphs that touch (thick strokes / antialiasing at small scales)
        merge into one connected component; split any box wider than 1.5x
        the median glyph width at the column-projection valley of its
        central third, recursively."""
        if len(boxes) < 3:
            return boxes
        median_w = float(np.median([x1 - x0 for x0, _, x1, _ in boxes]))
        out: list[tuple[int, int, int, int]] = []
        stack = list(boxes)
        while stack:
            x0, y0, x1, y1 = stack.pop(0)
            w = x1 - x0
            if w <= 1.5 * median_w or w < 6:
                out.append((x0, y0, x1, y1))
                continue
            colsum = (binary[y0:y1, x0:x1] > 0).sum(axis=0)
            lo, hi = w // 3, 2 * w // 3
            split = int(lo + np.argmin(colsum[lo:hi]))
            stack.insert(0, (x0 + split, y0, x1, y1))
            stack.insert(0, (x0, y0, x0 + split, y1))
        out.sort(key=lambda b: b[0])
        return out
