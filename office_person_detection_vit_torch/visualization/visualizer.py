"""Chart rendering (reference src/visualization/visualizer.py:39-589).

The port's own copy of ``office_person_detection_vit_tpu/visualization/visualizer.py``:
host-side matplotlib (Agg backend): detection-bbox drawing, attention-map
overlay, per-zone time-series plot, zone statistics bars, occupancy heatmap.
Consumes pipeline artifacts only, no device work.

matplotlib is imported when a chart is drawn, not with the module: a machine
without it can still run the pipeline with ``output.save_charts: false``
(ROADMAP C.5), and a chart asked for there raises.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from ..core.dto import AggregationResult, Detection
from ..utils.image_utils import draw_detections

logger = logging.getLogger(__name__)


def _pyplot():
    """matplotlib's pyplot on the Agg backend; a missing matplotlib raises
    with the key that turns the charts off."""
    try:
        import matplotlib
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            f"{e}: the charts of phase 5 need matplotlib; set output.save_charts: false to run without them "
            "(ROADMAP C.5)"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class Visualizer:
    def __init__(self, config: Any = None):
        self.config = config

    # -------------------------------------------------------------- images
    def draw_detections(
        self, frame: np.ndarray, detections: Sequence[Detection], **kwargs
    ) -> np.ndarray:
        """(reference visualizer.py:39)"""
        return draw_detections(frame, detections, **kwargs)

    def overlay_attention_map(
        self,
        frame: np.ndarray,
        attention: np.ndarray,
        alpha: float = 0.45,
        output_path: str | Path | None = None,
    ) -> np.ndarray:
        """Resize the (fh, fw) attention heat map onto the frame with a jet
        colormap + colorbar strip (reference :148-265)."""
        import cv2

        h, w = frame.shape[:2]
        amap = attention.astype(np.float32)
        amap = (amap - amap.min()) / max(float(amap.max() - amap.min()), 1e-12)
        amap = cv2.resize(amap, (w, h), interpolation=cv2.INTER_CUBIC)
        heat = cv2.applyColorMap((amap * 255).astype(np.uint8), cv2.COLORMAP_JET)
        blend = cv2.addWeighted(frame, 1.0 - alpha, heat, alpha, 0.0)
        # Colorbar strip on the right edge.
        bar = cv2.applyColorMap(
            np.linspace(255, 0, h, dtype=np.uint8).reshape(-1, 1), cv2.COLORMAP_JET
        )
        out = np.concatenate([blend, np.repeat(bar, 24, axis=1)], axis=1)
        if output_path is not None:
            Path(output_path).parent.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(output_path), out)
        return out

    # --------------------------------------------------------------- charts
    def plot_time_series(
        self,
        results: Sequence[AggregationResult],
        output_path: str | Path,
        title: str = "Zone occupancy over time",
    ) -> Path | None:
        """Per-zone person count vs timestamp (reference :363)."""
        if not results:
            logger.warning("no aggregation results; skipping time series")
            return None
        plt = _pyplot()
        zones = sorted({z for r in results for z in r.zone_counts})
        x = [r.timestamp for r in results]
        fig, ax = plt.subplots(figsize=(12, 6))
        for zone in zones:
            ax.plot(
                x,
                [r.zone_counts.get(zone, 0) for r in results],
                marker="o", markersize=3, label=zone,
            )
        ax.set_title(title)
        ax.set_xlabel("time")
        ax.set_ylabel("person count")
        ax.legend(loc="upper right", fontsize=8)
        ax.grid(alpha=0.3)
        step = max(1, len(x) // 12)
        ax.set_xticks(range(0, len(x), step))
        ax.set_xticklabels([x[i] for i in range(0, len(x), step)], rotation=45, ha="right", fontsize=7)
        return self._save(fig, output_path)

    def plot_zone_statistics(
        self,
        statistics: dict[str, dict[str, float]],
        output_path: str | Path,
    ) -> Path | None:
        """avg/max per zone bars (reference :448)."""
        if not statistics:
            return None
        plt = _pyplot()
        zones = list(statistics)
        avg = [statistics[z].get("avg", 0.0) for z in zones]
        mx = [statistics[z].get("max", 0.0) for z in zones]
        xpos = np.arange(len(zones))
        fig, ax = plt.subplots(figsize=(10, 6))
        ax.bar(xpos - 0.2, avg, width=0.4, label="average")
        ax.bar(xpos + 0.2, mx, width=0.4, label="max")
        ax.set_xticks(xpos)
        ax.set_xticklabels(zones, rotation=30, ha="right")
        ax.set_ylabel("person count")
        ax.set_title("Zone statistics")
        ax.legend()
        ax.grid(axis="y", alpha=0.3)
        return self._save(fig, output_path)

    def plot_heatmap(
        self,
        results: Sequence[AggregationResult],
        output_path: str | Path,
    ) -> Path | None:
        """timestamp × zone count matrix heat map (reference :511)."""
        if not results:
            return None
        plt = _pyplot()
        zones = sorted({z for r in results for z in r.zone_counts})
        matrix = np.asarray(
            [[r.zone_counts.get(z, 0) for z in zones] for r in results], np.float32
        )
        fig, ax = plt.subplots(figsize=(10, max(4, len(results) * 0.25)))
        im = ax.imshow(matrix, aspect="auto", cmap="YlOrRd")
        ax.set_xticks(range(len(zones)))
        ax.set_xticklabels(zones, rotation=30, ha="right")
        step = max(1, len(results) // 20)
        ax.set_yticks(range(0, len(results), step))
        ax.set_yticklabels([results[i].timestamp for i in range(0, len(results), step)], fontsize=7)
        fig.colorbar(im, ax=ax, label="person count")
        ax.set_title("Occupancy heatmap")
        return self._save(fig, output_path)

    @staticmethod
    def _save(fig, output_path: str | Path) -> Path:
        out = Path(output_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        fig.tight_layout()
        fig.savefig(out, dpi=120)
        _pyplot().close(fig)
        return out
