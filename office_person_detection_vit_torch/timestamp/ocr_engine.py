"""Multi-engine OCR with consensus (reference src/timestamp/ocr_engine.py:32-434).

Engine registry with availability gating (tesseract subprocess, easyocr,
paddleocr, built-in template matcher), parallel execution across engines,
three consensus modes (baseline similarity, weighted, 2/3 voting),
format-based confidence scoring and Levenshtein similarity.

The port's own copy of ``office_person_detection_vit_tpu/timestamp/ocr_engine.py`` (host code, unchanged).
"""

from __future__ import annotations

import logging
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .template_ocr import TemplateOCREngine
from .zoning_ocr import ZoningOCREngine

logger = logging.getLogger(__name__)

TIMESTAMP_FORMAT_RE = re.compile(
    r"^\d{4}/\d{2}/\d{2}\s+\d{2}:\d{2}(:\d{2})?$"
)


def levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def similarity(a: str, b: str) -> float:
    """1 - normalized edit distance (reference ocr_engine.py:412-434)."""
    if not a and not b:
        return 1.0
    m = max(len(a), len(b))
    return 1.0 - levenshtein(a, b) / m if m else 1.0


def format_confidence(text: str) -> float:
    """Score how timestamp-shaped a string is (reference :381-410)."""
    t = text.strip()
    if not t:
        return 0.0
    if TIMESTAMP_FORMAT_RE.match(t):
        return 1.0
    digits = sum(c.isdigit() for c in t)
    frac = digits / max(len(t), 1)
    bonus = 0.2 if ("/" in t) else 0.0
    bonus += 0.2 if (":" in t) else 0.0
    return min(0.6 * frac + bonus, 0.95)


class TesseractEngine:
    name = "tesseract"

    def __init__(self, config: str = "--psm 8 --oem 3", whitelist: str = "0123456789/:  "):
        self.config = config
        self.whitelist = whitelist

    def is_available(self) -> bool:
        return shutil.which("tesseract") is not None

    def extract(self, image: np.ndarray) -> tuple[str, float]:  # pragma: no cover
        import cv2

        with tempfile.TemporaryDirectory() as td:
            src = Path(td) / "roi.png"
            cv2.imwrite(str(src), image)
            cmd = ["tesseract", str(src), "stdout", *self.config.split()]
            if self.whitelist:
                cmd += ["-c", f"tessedit_char_whitelist={self.whitelist}"]
            try:
                out = subprocess.run(
                    cmd, capture_output=True, text=True, timeout=10, check=False
                )
                text = out.stdout.strip()
                return text, format_confidence(text)
            except Exception as e:
                logger.debug("tesseract failed: %s", e)
                return "", 0.0


class EasyOCREngine:  # pragma: no cover - optional dependency
    name = "easyocr"

    def __init__(self):
        self._reader = None

    def is_available(self) -> bool:
        try:
            import easyocr  # noqa: F401

            return True
        except Exception:
            return False

    def extract(self, image: np.ndarray) -> tuple[str, float]:
        import easyocr

        if self._reader is None:
            self._reader = easyocr.Reader(["en"], gpu=False, verbose=False)
        results = self._reader.readtext(image, allowlist="0123456789/: ")
        if not results:
            return "", 0.0
        text = " ".join(r[1] for r in results)
        conf = float(np.mean([r[2] for r in results]))
        return text, conf


class PaddleOCREngine:  # pragma: no cover - optional dependency
    name = "paddleocr"

    def __init__(self):
        self._ocr = None

    def is_available(self) -> bool:
        try:
            import paddleocr  # noqa: F401

            return True
        except Exception:
            return False

    def extract(self, image: np.ndarray) -> tuple[str, float]:
        from paddleocr import PaddleOCR

        if self._ocr is None:
            self._ocr = PaddleOCR(use_angle_cls=False, lang="en", show_log=False)
        result = self._ocr.ocr(image, cls=False)
        if not result or not result[0]:
            return "", 0.0
        texts = [line[1][0] for line in result[0]]
        confs = [line[1][1] for line in result[0]]
        return " ".join(texts), float(np.mean(confs))


ENGINE_REGISTRY = {
    "tesseract": TesseractEngine,
    "easyocr": EasyOCREngine,
    "paddleocr": PaddleOCREngine,
    "template": TemplateOCREngine,
    "zoning": ZoningOCREngine,
}

#: Consensus weights (reference :239-309: tesseract 1.0, others 0.8).
ENGINE_WEIGHTS = {"tesseract": 1.0, "template": 0.9, "zoning": 0.85,
                  "easyocr": 0.8, "paddleocr": 0.8}


class MultiEngineOCR:
    def __init__(
        self,
        engines: list[str] | None = None,
        consensus: str = "weighted",
        tesseract_config: str = "--psm 8 --oem 3",
        tesseract_whitelist: str = "0123456789/:  ",
    ):
        requested = engines or ["tesseract", "template", "zoning"]
        self.engines = []
        for name in requested:
            cls = ENGINE_REGISTRY.get(name)
            if cls is None:
                logger.warning("unknown OCR engine %s", name)
                continue
            eng = (
                cls(tesseract_config, tesseract_whitelist)
                if name == "tesseract"
                else cls()
            )
            if eng.is_available():
                self.engines.append(eng)
            else:
                logger.info("OCR engine %s unavailable; skipping", name)
        if not self.engines:
            # Always have at least the template engine as a last resort.
            self.engines = [TemplateOCREngine()]
        self.consensus = consensus

    @classmethod
    def from_config(cls, cfg) -> "MultiEngineOCR":
        return cls(
            engines=cfg.get("ocr.engines", ["tesseract", "template", "zoning"]),
            consensus=cfg.get("ocr.consensus", "weighted"),
            tesseract_config=cfg.get("ocr.tesseract.config", "--psm 8 --oem 3"),
            tesseract_whitelist=cfg.get("ocr.tesseract.whitelist", "0123456789/:  "),
        )

    def _run_all(self, image: np.ndarray) -> list[tuple[str, str, float]]:
        """[(engine, text, conf)] — engines run in parallel threads
        (reference :207-216)."""
        if len(self.engines) == 1:
            eng = self.engines[0]
            text, conf = eng.extract(image)
            return [(eng.name, text, conf)]
        with ThreadPoolExecutor(max_workers=len(self.engines)) as ex:
            futures = {ex.submit(e.extract, image): e.name for e in self.engines}
            out = []
            for fut, name in futures.items():
                try:
                    text, conf = fut.result(timeout=30)
                except Exception as e:
                    logger.debug("engine %s failed: %s", name, e)
                    text, conf = "", 0.0
                out.append((name, text, conf))
        return out

    def extract_with_consensus(self, image: np.ndarray) -> tuple[str, float]:
        results = [(n, t, c) for n, t, c in self._run_all(image) if t]
        if not results:
            return "", 0.0
        if len(results) == 1:
            _, text, conf = results[0]
            return text, conf * format_confidence(text) ** 0.5

        if self.consensus == "baseline":
            # Top-2 by confidence must agree (similarity > 0.8), else best.
            top = sorted(results, key=lambda r: -r[2])[:2]
            if similarity(top[0][1], top[1][1]) > 0.8:
                return top[0][1], (top[0][2] + top[1][2]) / 2
            return top[0][1], top[0][2] * 0.7
        if self.consensus == "voting":
            # 2-of-N exact agreement wins.
            from collections import Counter

            counts = Counter(t for _, t, _ in results)
            text, n = counts.most_common(1)[0]
            if n >= 2:
                confs = [c for _, t, c in results if t == text]
                return text, float(np.mean(confs))
            # fall through to weighted
        # weighted (default): score = engine weight * conf * format score.
        best_text, best_score, best_conf = "", -1.0, 0.0
        for name, text, conf in results:
            score = ENGINE_WEIGHTS.get(name, 0.8) * conf * max(format_confidence(text), 0.1)
            if score > best_score:
                best_text, best_score, best_conf = text, score, conf
        return best_text, best_conf
