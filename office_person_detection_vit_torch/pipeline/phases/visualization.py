"""Phase 5: visualization
(reference src/pipeline/phases/visualization.py:29-138).

Mirrors ``office_person_detection_vit_tpu/pipeline/phases/visualization.py``:
time-series, statistics and heatmap PNGs, and one floormap PNG a frame
rendered on a thread pool (reference visualization.py:88-95), all with
OpenCV. All host-side; runs after the device phases. Two differences:

* ``output.save_charts`` (a port-only key, default true) turns the three
  charts off. The port draws them without matplotlib (ROADMAP C.5).
* ``output.save_side_by_side_video: true`` raises ``NotImplementedError``:
  the side-by-side exporter is not ported (ROADMAP A.3).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

from ...core.dto import AggregationResult, FrameResult
from ...visualization.floormap_visualizer import FloormapVisualizer
from ...visualization.visualizer import Visualizer
from .base import BasePhase

SIDE_BY_SIDE_REFUSAL = (
    "output.save_side_by_side_video: the side-by-side video exporter (utils/export_utils.py) is not ported "
    "yet (ROADMAP A.3)"
)


class VisualizationPhase(BasePhase):
    name = "06_visualization"

    def __init__(self, config: Any, logger=None):
        super().__init__(config, logger)
        if config.get("output.save_side_by_side_video", False):
            raise NotImplementedError(SIDE_BY_SIDE_REFUSAL)
        self.visualizer = Visualizer(config)
        self.floormap_visualizer = FloormapVisualizer(config)
        self.save_charts = bool(config.get("output.save_charts", True))
        self.save_floormaps = bool(config.get("output.save_floormap_images", True))
        self.generated: dict[str, Any] = {}

    def execute(
        self,
        frame_results: list[FrameResult],
        aggregation_results: list[AggregationResult],
        output_dir: str | Path,
        zone_statistics: dict[str, dict[str, float]] | None = None,
        detection_image_dir: str | Path | None = None,
    ) -> dict[str, Any]:
        self.log_banner()
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        generated: dict[str, Any] = {}

        if self.save_charts:
            generated["time_series"] = self.visualizer.plot_time_series(
                aggregation_results, out / "zone_time_series.png"
            )
            if zone_statistics:
                generated["statistics"] = self.visualizer.plot_zone_statistics(
                    zone_statistics, out / "zone_statistics.png"
                )
            generated["heatmap"] = self.visualizer.plot_heatmap(
                aggregation_results, out / "zone_heatmap.png"
            )

        floormap_dir = out / "floormaps"
        if self.save_floormaps and frame_results:
            floormap_dir.mkdir(exist_ok=True)

            def _render(i_fr):
                i, fr = i_fr
                stem = fr.timestamp_stem
                traj = self.floormap_visualizer.collect_trajectories(frame_results, up_to=i)
                return self.floormap_visualizer.visualize_frame(
                    fr, floormap_dir / f"floormap_{stem}.png", trajectories=traj
                )

            # Parallel renders (reference phases/visualization.py:88-95).
            with ThreadPoolExecutor(max_workers=4) as ex:
                list(ex.map(_render, enumerate(frame_results)))
            generated["floormaps"] = len(frame_results)
            self.logger.info("rendered %d floormaps", len(frame_results))

        self.generated = generated
        return generated
