"""Chart rendering (reference src/visualization/visualizer.py:39-589).

The port's own copy of ``office_person_detection_vit_tpu/visualization/visualizer.py``:
detection-bbox drawing, attention-map overlay, per-zone time-series plot,
zone statistics bars, occupancy heatmap. Consumes pipeline artifacts only, no
device work.

The three charts are drawn with OpenCV and numpy, not matplotlib (the card
machine has no matplotlib; ROADMAP C.5, resolved): the same series, the same
image size as the JAX package's matplotlib figures (figsize x 120 dpi), axes,
ticks, grid, legend and colorbar drawn by hand. The series come from
:func:`time_series_data`, :func:`zone_statistics_data` and
:func:`heatmap_data`, which read the inputs as the JAX ``Visualizer`` does.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from ..core.dto import AggregationResult, Detection
from ..utils.image_utils import draw_detections

logger = logging.getLogger(__name__)


DPI = 120
#: matplotlib's tab10 cycle, BGR.
_COLORS = [(180, 119, 31), (14, 127, 255), (44, 160, 44), (40, 39, 214), (189, 103, 148),
           (75, 86, 140), (194, 119, 227), (127, 127, 127), (34, 189, 188), (207, 190, 23)]
#: YlOrRd anchors (low -> high), BGR.
_YLORRD = np.array([(204, 255, 255), (160, 237, 255), (118, 217, 254), (76, 178, 254), (60, 141, 253),
                    (42, 78, 252), (28, 26, 227), (38, 0, 189), (38, 0, 128)], np.float32)
_FONT = 0  # cv2.FONT_HERSHEY_SIMPLEX


def time_series_data(results: Sequence[AggregationResult]):
    """-> (zones sorted, x labels, {zone: counts}) as the JAX chart plots them."""
    zones = sorted({z for r in results for z in r.zone_counts})
    return zones, [r.timestamp for r in results], {
        z: [r.zone_counts.get(z, 0) for r in results] for z in zones}


def zone_statistics_data(statistics: dict[str, dict[str, float]]):
    """-> (zones, averages, maxima)."""
    zones = list(statistics)
    return (zones, [statistics[z].get("avg", 0.0) for z in zones],
            [statistics[z].get("max", 0.0) for z in zones])


def heatmap_data(results: Sequence[AggregationResult]):
    """-> (zones sorted, timestamps, (len(results), len(zones)) float32 counts)."""
    zones = sorted({z for r in results for z in r.zone_counts})
    matrix = np.asarray([[r.zone_counts.get(z, 0) for z in zones] for r in results], np.float32)
    return zones, [r.timestamp for r in results], matrix


def _nice_max(v: float) -> float:
    """Upper end of a value axis: a round number at or above ``v``."""
    if v <= 0:
        return 1.0
    mag = 10.0 ** np.floor(np.log10(v))
    for m in (1.0, 2.0, 2.5, 5.0, 10.0):
        if m * mag >= v:
            return float(m * mag)
    return float(10 * mag)


class _Chart:
    """A white canvas of figsize x DPI with one plot area and a value axis
    from 0 to ``ymax``."""

    def __init__(self, figsize: tuple[float, float], ymax: float, title: str, ylabel: str,
                 margins=(90, 60, 40, 130)):
        import cv2

        self.cv2 = cv2
        w, h = (int(round(DPI * d)) for d in figsize)
        self.img = np.full((h, w, 3), 255, np.uint8)
        left, top, right, bottom = margins
        self.x0, self.y0, self.x1, self.y1 = left, top, w - right, h - bottom
        self.ymax = ymax
        self.text(title, ((self.x0 + self.x1) // 2, top // 2 + 8), 0.7, center=True, thick=2)
        self.text(ylabel, (8, top - 14), 0.5)

    def text(self, s: str, org, scale=0.45, color=(0, 0, 0), center=False, right=False, thick=1):
        (tw, th), _ = self.cv2.getTextSize(str(s), _FONT, scale, thick)
        x, y = org
        if center:
            x -= tw // 2
        elif right:
            x -= tw
        self.cv2.putText(self.img, str(s), (int(x), int(y)), _FONT, scale, color, thick, self.cv2.LINE_AA)

    def y_px(self, v: float) -> int:
        return int(round(self.y1 - (self.y1 - self.y0) * v / self.ymax))

    def value_axis(self, grid: bool = True) -> None:
        for v in np.linspace(0.0, self.ymax, 6):
            y = self.y_px(v)
            if grid:
                self.cv2.line(self.img, (self.x0, y), (self.x1, y), (225, 225, 225), 1)
            self.text(f"{v:g}", (self.x0 - 8, y + 5), right=True)
        self.cv2.rectangle(self.img, (self.x0, self.y0), (self.x1, self.y1), (0, 0, 0), 1)

    def category_labels(self, labels: Sequence[str], xs: Sequence[float], scale=0.4) -> None:
        for i, (label, x) in enumerate(zip(labels, xs)):
            dy = 18 if i % 2 else 0  # stagger neighbours instead of rotating
            self.cv2.line(self.img, (int(x), self.y1), (int(x), self.y1 + 5), (0, 0, 0), 1)
            self.text(label, (x, self.y1 + 22 + dy), scale, center=True)

    def legend(self, names: Sequence[str], colors) -> None:
        for i, (name, color) in enumerate(zip(names, colors)):
            y = self.y0 + 18 + 20 * i
            self.cv2.rectangle(self.img, (self.x1 - 150, y - 9), (self.x1 - 136, y + 3), color, -1)
            self.text(name, (self.x1 - 128, y + 2))

    def save(self, output_path: str | Path) -> Path:
        out = Path(output_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        if not self.cv2.imwrite(str(out), self.img):
            raise OSError(f"could not write {out}")
        return out


def scatter_chart(groups: Sequence[tuple[str, np.ndarray, tuple, str]], output_path: str | Path, title: str,
                  figsize: tuple[float, float], segments: Sequence[tuple[np.ndarray, np.ndarray]] = (),
                  invert_y: bool = False, legend: bool = True) -> Path:
    """A scatter plot drawn with OpenCV, as the matplotlib scatters of the
    JAX package lay it out: ``groups`` of (name, (N, 2) points, BGR colour,
    marker ``"o"`` or ``"x"``), grey ``segments`` (start and end points,
    each (M, 2)) under them, both axes fitted to the data with a 5% margin
    and five labelled ticks each, ``invert_y`` puts y's smallest value at
    the top, and a legend of the group names."""
    c = _Chart(figsize, 1.0, title, "", margins=(90, 60, 40, 60))
    cv2 = c.cv2
    pts = np.concatenate([np.asarray(p, np.float64).reshape(-1, 2) for _, p, _, _ in groups]
                         + [np.asarray(s, np.float64).reshape(-1, 2) for pair in segments for s in pair])
    lo, hi = (pts.min(0), pts.max(0)) if len(pts) else (np.zeros(2), np.ones(2))
    pad = np.maximum(hi - lo, 1e-9) * 0.05
    lo, hi = lo - pad, hi + pad

    def px(p: np.ndarray) -> np.ndarray:
        f = (np.asarray(p, np.float64).reshape(-1, 2) - lo) / (hi - lo)
        y = c.y0 + f[:, 1] * (c.y1 - c.y0) if invert_y else c.y1 - f[:, 1] * (c.y1 - c.y0)
        return np.round(np.stack([c.x0 + f[:, 0] * (c.x1 - c.x0), y], 1)).astype(np.int32)

    for t in np.linspace(0.0, 1.0, 5):
        x = int(round(c.x0 + t * (c.x1 - c.x0)))
        y = int(round(c.y0 + t * (c.y1 - c.y0) if invert_y else c.y1 - t * (c.y1 - c.y0)))
        cv2.line(c.img, (x, c.y1), (x, c.y1 + 5), (0, 0, 0), 1)
        c.text(f"{lo[0] + t * (hi[0] - lo[0]):.4g}", (x, c.y1 + 22), 0.4, center=True)
        cv2.line(c.img, (c.x0 - 5, y), (c.x0, y), (0, 0, 0), 1)
        c.text(f"{lo[1] + t * (hi[1] - lo[1]):.4g}", (c.x0 - 8, y + 5), 0.4, right=True)
    cv2.rectangle(c.img, (c.x0, c.y0), (c.x1, c.y1), (0, 0, 0), 1)
    for a, b in segments:
        for p, q in zip(px(a), px(b)):
            cv2.line(c.img, tuple(map(int, p)), tuple(map(int, q)), (153, 153, 153), 1, cv2.LINE_AA)
    for _, points, color, marker in groups:
        for x, y in px(points):
            if marker == "x":
                cv2.line(c.img, (x - 4, y - 4), (x + 4, y + 4), color, 2, cv2.LINE_AA)
                cv2.line(c.img, (x - 4, y + 4), (x + 4, y - 4), color, 2, cv2.LINE_AA)
            else:
                cv2.circle(c.img, (int(x), int(y)), 4, color, -1, cv2.LINE_AA)
    if legend:
        c.legend([name for name, _, _, _ in groups], [color for _, _, color, _ in groups])
    return c.save(output_path)


def _ylorrd(t: np.ndarray) -> np.ndarray:
    """Values in [0, 1] -> BGR uint8 on the YlOrRd ramp."""
    pos = np.clip(t, 0.0, 1.0) * (len(_YLORRD) - 1)
    i = np.minimum(pos.astype(np.int64), len(_YLORRD) - 2)
    f = (pos - i)[..., None]
    return np.round(_YLORRD[i] * (1 - f) + _YLORRD[i + 1] * f).astype(np.uint8)


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
        zones, x, series = time_series_data(results)
        ymax = _nice_max(max((max(v) for v in series.values()), default=0))
        c = _Chart((12, 6), ymax, title, "person count")
        c.value_axis()
        n = len(x)
        xs = [c.x0 + (c.x1 - c.x0) * (i + 0.5) / n for i in range(n)]
        colors = [_COLORS[i % len(_COLORS)] for i in range(len(zones))]
        for zone, color in zip(zones, colors):
            pts = np.array([[xs[i], c.y_px(v)] for i, v in enumerate(series[zone])], np.int32)
            c.cv2.polylines(c.img, [pts], False, color, 2, c.cv2.LINE_AA)
            for p in pts:
                c.cv2.circle(c.img, (int(p[0]), int(p[1])), 3, color, -1, c.cv2.LINE_AA)
        step = max(1, n // 12)
        c.category_labels([x[i] for i in range(0, n, step)], xs[::step], scale=0.35)
        c.text("time", ((c.x0 + c.x1) // 2, c.img.shape[0] - 12), 0.5, center=True)
        c.legend(zones, colors)
        return c.save(output_path)

    def plot_zone_statistics(
        self,
        statistics: dict[str, dict[str, float]],
        output_path: str | Path,
    ) -> Path | None:
        """avg/max per zone bars (reference :448)."""
        if not statistics:
            return None
        zones, avg, mx = zone_statistics_data(statistics)
        c = _Chart((10, 6), _nice_max(max(max(avg), max(mx))), "Zone statistics", "person count")
        c.value_axis()
        n = len(zones)
        slot = (c.x1 - c.x0) / n
        xs = [c.x0 + slot * (i + 0.5) for i in range(n)]
        for values, color, off in ((avg, _COLORS[0], -0.2), (mx, _COLORS[1], 0.2)):
            for x, v in zip(xs, values):
                left = int(round(x + (off - 0.2) * slot * 0.8))
                right = int(round(x + (off + 0.2) * slot * 0.8))
                c.cv2.rectangle(c.img, (left, c.y_px(v)), (right, c.y1), color, -1)
        c.category_labels(zones, xs)
        c.legend(["average", "max"], [_COLORS[0], _COLORS[1]])
        return c.save(output_path)

    def plot_heatmap(
        self,
        results: Sequence[AggregationResult],
        output_path: str | Path,
    ) -> Path | None:
        """timestamp x zone count matrix heat map (reference :511)."""
        if not results:
            return None
        zones, stamps, matrix = heatmap_data(results)
        c = _Chart((10, max(4, len(results) * 0.25)), 1.0, "Occupancy heatmap", "",
                   margins=(170, 50, 150, 70))
        lo, hi = float(matrix.min()), float(matrix.max())
        cells = _ylorrd((matrix - lo) / max(hi - lo, 1e-12))
        c.img[c.y0:c.y1, c.x0:c.x1] = c.cv2.resize(cells, (c.x1 - c.x0, c.y1 - c.y0),
                                                    interpolation=c.cv2.INTER_NEAREST)
        c.cv2.rectangle(c.img, (c.x0, c.y0), (c.x1, c.y1), (0, 0, 0), 1)
        nz, nr = len(zones), len(results)
        c.category_labels(zones, [c.x0 + (c.x1 - c.x0) * (i + 0.5) / nz for i in range(nz)])
        step = max(1, nr // 20)
        for i in range(0, nr, step):
            y = c.y0 + (c.y1 - c.y0) * (i + 0.5) / nr
            c.text(stamps[i], (c.x0 - 6, y + 4), 0.35, right=True)
        # Colorbar with its value ticks.
        bx0, bx1 = c.x1 + 25, c.x1 + 45
        ramp = _ylorrd(np.linspace(1.0, 0.0, c.y1 - c.y0, dtype=np.float32))[:, None, :]
        c.img[c.y0:c.y1, bx0:bx1] = np.repeat(ramp, bx1 - bx0, axis=1)
        c.cv2.rectangle(c.img, (bx0, c.y0), (bx1, c.y1), (0, 0, 0), 1)
        for v in np.linspace(lo, hi, 5):
            y = int(round(c.y1 - (c.y1 - c.y0) * (v - lo) / max(hi - lo, 1e-12)))
            c.text(f"{v:g}", (bx1 + 6, y + 5), 0.4)
        c.text("person count", (bx0 - 10, c.y0 - 12), 0.4)
        return c.save(output_path)
