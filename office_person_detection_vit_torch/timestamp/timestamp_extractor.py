"""Integrated timestamp extraction (reference src/timestamp/timestamp_extractor_v2.py).

ROI -> OCR consensus -> fuzzy parse -> temporal validation, with:
- MD5-keyed thread-safe OCR result cache (256 entries, critical for the
  ~313x timelapse's duplicate ROIs — reference :92-110);
- bounded retries (reference :155-175);
- parallel batch extraction over frames (ThreadPool, reference :253-290) —
  the host-side producer that feeds the prefetch queue.

The port's own copy of ``office_person_detection_vit_tpu/timestamp/timestamp_extractor.py`` (host code; only this docstring differs).
"""

from __future__ import annotations

import hashlib
import logging
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime

import numpy as np

from .ocr_engine import MultiEngineOCR, format_confidence
from .roi_extractor import TimestampROIExtractor
from .timestamp_parser import TimestampParser
from .timestamp_validator import NoOpValidator, TemporalValidatorV2, ValidationResult

logger = logging.getLogger(__name__)

CACHE_SIZE = 256


class TimestampExtractorV2:
    def __init__(
        self,
        roi_extractor: TimestampROIExtractor | None = None,
        ocr_engine: MultiEngineOCR | None = None,
        parser: TimestampParser | None = None,
        validator=None,
        confidence_threshold: float = 0.5,
        retry_count: int = 3,
        max_workers: int = 4,
    ):
        self.roi_extractor = roi_extractor or TimestampROIExtractor()
        self.ocr = ocr_engine or MultiEngineOCR()
        self.parser = parser or TimestampParser()
        self.validator = validator if validator is not None else NoOpValidator()
        self.confidence_threshold = float(confidence_threshold)
        self.retry_count = int(retry_count)
        self.max_workers = int(max_workers)
        self._cache: OrderedDict[str, tuple[str, float]] = OrderedDict()
        self._lock = threading.Lock()
        self.cache_hits = 0
        self.cache_misses = 0

    @classmethod
    def from_config(cls, cfg, validator=None) -> "TimestampExtractorV2":
        if validator is None:
            if cfg.get("timestamp.auto_targets.disable_validation", False):
                validator = NoOpValidator()
            else:
                validator = TemporalValidatorV2.from_config(cfg)
        return cls(
            roi_extractor=TimestampROIExtractor.from_config(cfg),
            ocr_engine=MultiEngineOCR.from_config(cfg),
            validator=validator,
            confidence_threshold=float(
                cfg.get("timestamp.extraction.confidence_threshold", 0.5)
            ),
            retry_count=int(cfg.get("timestamp.extraction.retry_count", 3)),
        )

    # ------------------------------------------------------------------ API
    def extract(
        self, frame: np.ndarray, frame_number: int = 0
    ) -> tuple[datetime | None, float]:
        """One frame -> (timestamp or None, combined confidence)."""
        roi = self.roi_extractor.extract_roi(frame)
        if roi.size == 0:
            return None, 0.0
        processed = self.roi_extractor.preprocess_roi(roi)

        text, ocr_conf = self._cached_ocr(processed)
        ts = self.parser.fuzzy_parse(text) if text else None
        attempts = 1
        while ts is None and attempts < self.retry_count:
            # Retry with a genuinely different preprocessing per attempt —
            # OCR is deterministic, so re-running identical input is wasted
            # latency. Attempt 2 blurs, attempt 3 sharpens, etc.
            import cv2

            k = 3 + 2 * attempts  # 5, 7, ...
            if attempts % 2 == 1:
                alt = cv2.GaussianBlur(processed, (k, k), 0)
            else:
                blurred = cv2.GaussianBlur(processed, (k, k), 0)
                alt = cv2.addWeighted(processed, 1.8, blurred, -0.8, 0)
            text, ocr_conf = self.ocr.extract_with_consensus(alt)
            ts = self.parser.fuzzy_parse(text) if text else None
            attempts += 1
        if ts is None:
            return None, 0.0

        fmt_conf = format_confidence(text)
        result: ValidationResult = self.validator.validate(ts, frame_number, ocr_conf)
        if not result.is_valid:
            return None, 0.0
        val_conf = result.confidence if result.confidence is not None else 1.0
        # Combined confidence = mean of OCR / format / validation scores
        # (reference :199-201).
        combined = float(np.mean([ocr_conf, fmt_conf, val_conf]))
        if combined < self.confidence_threshold:
            return None, combined
        return result.timestamp, combined

    def extract_batch_parallel(
        self, frames: list[tuple[int, np.ndarray]]
    ) -> list[tuple[int, datetime | None, float]]:
        """[(frame_number, frame)] -> [(frame_number, ts, conf)], OCR'd on a
        thread pool (order preserved). Validation is applied afterwards in
        frame order (it is stateful)."""
        def _ocr_only(item):
            fn, frame = item
            roi = self.roi_extractor.extract_roi(frame)
            if roi.size == 0:
                return fn, None, 0.0
            processed = self.roi_extractor.preprocess_roi(roi)
            text, conf = self._cached_ocr(processed)
            ts = self.parser.fuzzy_parse(text) if text else None
            return fn, ts, (conf if ts else 0.0), format_confidence(text)

        with ThreadPoolExecutor(max_workers=self.max_workers) as ex:
            raw = list(ex.map(_ocr_only, frames))

        out: list[tuple[int, datetime | None, float]] = []
        for fn, ts, conf, *rest in sorted(raw, key=lambda r: r[0]):
            if ts is None:
                out.append((fn, None, 0.0))
                continue
            result = self.validator.validate(ts, fn, conf)
            if not result.is_valid:
                out.append((fn, None, 0.0))
                continue
            fmt_conf = rest[0] if rest else 1.0
            combined = float(np.mean([conf, fmt_conf, result.confidence if result.confidence is not None else 1.0]))
            out.append((fn, result.timestamp, combined))
        return out

    # ---------------------------------------------------------------- cache
    def _cached_ocr(self, processed_roi: np.ndarray) -> tuple[str, float]:
        key = hashlib.md5(processed_roi.tobytes()).hexdigest()
        with self._lock:
            if key in self._cache:
                self.cache_hits += 1
                self._cache.move_to_end(key)
                return self._cache[key]
            self.cache_misses += 1
        result = self.ocr.extract_with_consensus(processed_roi)
        with self._lock:
            self._cache[key] = result
            self._cache.move_to_end(key)
            while len(self._cache) > CACHE_SIZE:
                self._cache.popitem(last=False)
        return result

    def get_cache_stats(self) -> dict[str, float]:
        total = self.cache_hits + self.cache_misses
        return {
            "hits": self.cache_hits,
            "misses": self.cache_misses,
            "hit_rate": self.cache_hits / total if total else 0.0,
            "size": len(self._cache),
        }
