"""Performance service (reference src/services/perf_service.py:19-26).

The port's own copy of ``office_person_detection_vit_tpu/services/perf_service.py``:
a facade over :class:`PerformanceMonitor`, plus a ``torch.profiler`` trace
of a whole run when ``performance.trace_dir`` is set (the orchestrator's
``run`` enters it).
"""

from __future__ import annotations

from typing import Any

from ..utils.performance_monitor import PerformanceMonitor


class PerformanceService:
    def __init__(self, trace_dir: str | None = None):
        self.monitor = PerformanceMonitor()
        self.trace_dir = trace_dir

    def __enter__(self) -> "PerformanceService":
        if self.trace_dir:
            self.monitor.start_trace(self.trace_dir)
        return self

    def __exit__(self, *exc: object) -> None:
        self.monitor.stop_trace()

    def measure(self, name: str):
        return self.monitor.measure(name)

    def summary(self) -> dict[str, Any]:
        return self.monitor.get_summary()

    def log_summary(self) -> None:
        self.monitor.log_summary()
