"""Named-scope wall-time accumulation (reference
src/utils/performance_monitor.py:10-80) with ``torch.profiler`` integration.

The port's own copy of ``office_person_detection_vit_tpu/utils/performance_monitor.py``.
``measure("02_detection")`` accumulates total/count/min/max per name; the
orchestrator wraps every phase with it and persists the summary into
``summary.json["performance"]``. Device work is made observable two ways:

* each measured scope is also a ``torch.profiler.record_function`` range
  (where the JAX package opens a ``jax.profiler.TraceAnnotation``), so
  scopes show up in a captured trace;
* ``start_trace``/``stop_trace`` run a ``torch.profiler`` session over the
  CPU and, where there is a card, CUDA activity, and write its Chrome trace.

The card is synchronised at the end of a scope, so a phase's time includes
the device work it queued: CUDA launches return before the work ends.
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path
from typing import Any, Iterator

import torch

logger = logging.getLogger(__name__)


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PerformanceMonitor:
    def __init__(self) -> None:
        self._stats: dict[str, dict[str, float]] = {}
        self._profiler: torch.profiler.profile | None = None
        self._trace_dir: Path | None = None

    @contextlib.contextmanager
    def measure(self, name: str) -> Iterator[None]:
        _synchronize()
        start = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            _synchronize()
        elapsed = time.perf_counter() - start
        entry = self._stats.setdefault(
            name, {"total": 0.0, "count": 0, "min": float("inf"), "max": 0.0}
        )
        entry["total"] += elapsed
        entry["count"] += 1
        entry["min"] = min(entry["min"], elapsed)
        entry["max"] = max(entry["max"], elapsed)

    # ------------------------------------------------------------- profiler
    def start_trace(self, log_dir: str) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._trace_dir = Path(log_dir)
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.start()
        logger.info("torch profiler trace started -> %s", log_dir)

    def stop_trace(self) -> Path | None:
        """Stop the trace and write ``<log_dir>/trace.json``; returns its path."""
        if self._profiler is None:
            return None
        self._profiler.stop()
        self._trace_dir.mkdir(parents=True, exist_ok=True)
        path = self._trace_dir / "trace.json"
        self._profiler.export_chrome_trace(str(path))
        self._profiler = None
        logger.info("torch profiler trace written -> %s", path)
        return path

    # --------------------------------------------------------------- report
    def get_summary(self) -> dict[str, Any]:
        # Key names follow the summary.json performance contract
        # (schemas/summary.schema.json: total_time/count/avg_time/min_time/max_time).
        return {
            name: {
                "total_time": round(s["total"], 6),
                "count": int(s["count"]),
                "avg_time": round(s["total"] / max(s["count"], 1), 6),
                "min_time": round(s["min"], 6) if s["count"] else 0.0,
                "max_time": round(s["max"], 6),
            }
            for name, s in self._stats.items()
        }

    def log_summary(self) -> None:
        logger.info("=== performance summary ===")
        for name, s in self.get_summary().items():
            logger.info(
                "%s: total %.3fs over %d calls (avg %.3fs, min %.3fs, max %.3fs)",
                name,
                s["total_time"],
                s["count"],
                s["avg_time"],
                s["min_time"],
                s["max_time"],
            )

    def reset(self) -> None:
        self._stats.clear()
