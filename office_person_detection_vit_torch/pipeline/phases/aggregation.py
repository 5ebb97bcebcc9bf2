"""Phase 4: zone-count aggregation.

Mirrors ``office_person_detection_vit_tpu/pipeline/phases/aggregation.py``:
every frame's zone memberships go into the ``Aggregator`` (on
``detection.device``), its statistics, trends and peaks are logged, and it
writes ``zone_counts.csv``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

from ...aggregation.aggregator import Aggregator
from ...core.dto import AggregationResult, FrameResult
from ...device import config_device
from .base import BasePhase


class AggregationPhase(BasePhase):
    name = "05_aggregation"

    def __init__(self, config: Any, logger=None):
        super().__init__(config, logger)
        zone_ids = [z["id"] for z in config.get("zones", [])]
        self.aggregator = Aggregator(zone_ids, device=config_device(config))
        self.results: list[AggregationResult] = []

    def execute(self, frame_results: list[FrameResult], output_dir: str | Path | None = None) -> list[AggregationResult]:
        self.log_banner()
        self.aggregator.reset()
        self.results = []
        for fr in frame_results:
            res = self.aggregator.aggregate_frame(fr.timestamp_str, [d.zone_ids for d in fr.detections])
            fr.zone_counts = dict(res.zone_counts)
            self.results.append(res)

        for zone, s in self.aggregator.get_statistics().items():
            self.logger.info("zone %s: avg %.2f max %d min %d", zone, s["average"], int(s["max"]), int(s["min"]))
        for zone, t in self.aggregator.get_trend_analysis().items():
            self.logger.info("zone %s trend: slope %.4f r2 %.3f", zone, t["slope"], t["r_squared"])
        for peak in self.aggregator.get_peak_times(top_n=3):
            self.logger.info("peak: %s", peak)

        if output_dir is not None:
            out = Path(output_dir)
            out.mkdir(parents=True, exist_ok=True)
            self.aggregator.export_csv(out / "zone_counts.csv")
        return self.results
