"""Phase 5: visualization
(reference src/pipeline/phases/visualization.py:29-138).

Mirrors ``office_person_detection_vit_tpu/pipeline/phases/visualization.py``:
time-series, statistics and heatmap PNGs, one floormap PNG a frame
rendered on a thread pool (reference visualization.py:88-95), and with
``output.save_side_by_side_video`` the side-by-side MP4 of the detection
images and the floormaps (``output.side_by_side_video_fps``, and
``output.side_by_side_zoom`` to crop each floormap around its frame's floor
points), all with OpenCV. All host-side; runs after the device phases. One
difference: ``output.save_charts`` (a port-only key, default true) turns
the three charts off. The port draws them without matplotlib (ROADMAP C.5).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

from ...core.dto import AggregationResult, FrameResult
from ...utils.export_utils import SideBySideVideoExporter
from ...visualization.floormap_visualizer import FloormapVisualizer
from ...visualization.visualizer import Visualizer
from .base import BasePhase

class VisualizationPhase(BasePhase):
    name = "06_visualization"

    def __init__(self, config: Any, logger=None):
        super().__init__(config, logger)
        self.visualizer = Visualizer(config)
        self.floormap_visualizer = FloormapVisualizer(config)
        self.save_charts = bool(config.get("output.save_charts", True))
        self.save_floormaps = bool(config.get("output.save_floormap_images", True))
        self.save_video = bool(config.get("output.save_side_by_side_video", False))
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

        if self.save_video and detection_image_dir is not None:
            exporter = SideBySideVideoExporter(fps=float(self.config.get("output.side_by_side_video_fps", 1.0)))
            # Optional floormap crop/zoom around each frame's floor points
            # (reference export_utils.py:498 crop_and_zoom_floormap).
            points_by_key = None
            if bool(self.config.get("output.side_by_side_zoom", False)):
                points_by_key = {fr.timestamp_stem: [d.floor_coords_px for d in fr.detections
                                                     if d.floor_coords_px is not None]
                                 for fr in frame_results}
            generated["side_by_side"] = exporter.export(detection_image_dir, floormap_dir, out / "side_by_side.mp4",
                                                        floor_points_by_key=points_by_key)

        self.generated = generated
        return generated
