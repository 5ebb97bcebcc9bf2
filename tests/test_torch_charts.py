"""Phase 5's three charts drawn without matplotlib (ROADMAP C.5).

The port draws ``zone_time_series.png``, ``zone_statistics.png`` and
``zone_heatmap.png`` with OpenCV and numpy. Here they are rendered with
``sys.modules["matplotlib"] = None`` (any matplotlib import raises), and
checked: non-empty images of the JAX figures' size, and the plotted series
equal to what the JAX ``Visualizer`` hands matplotlib (its ``Axes.plot``,
``Axes.bar`` and ``Axes.imshow`` calls recorded) for the same inputs.
"""

import sys

import cv2
import matplotlib.axes
import numpy as np
import pytest

from office_person_detection_vit_torch.core import dto as port_dto
from office_person_detection_vit_torch.pipeline.phases.visualization import VisualizationPhase
from office_person_detection_vit_torch.visualization import visualizer as port_viz
from office_person_detection_vit_tpu.core import dto as jax_dto
from office_person_detection_vit_tpu.visualization.visualizer import Visualizer as JaxVisualizer

STATS = {"zone_1": {"avg": 1.25, "max": 3}, "zone_b": {"avg": 0.5, "max": 1}, "zone_0": {"avg": 2.0, "max": 4}}


def _results(dto, n=30):
    return [dto.AggregationResult(f"2025-01-20 {9 + i // 60:02d}:{i % 60:02d}:00",
                                  {"zone_1": i % 3, "zone_b": 1, **({"zone_0": (i * 7) % 5} if i % 4 else {})})
            for i in range(n)]


@pytest.fixture
def no_matplotlib(monkeypatch):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import matplotlib  # noqa: F401


def _jax_calls(tmp_path, monkeypatch):
    """What the JAX Visualizer hands matplotlib for each chart."""
    calls = {"plot": [], "bar": [], "imshow": []}
    for name in calls:
        orig = getattr(matplotlib.axes.Axes, name)

        def record(self, *args, _name=name, _orig=orig, **kw):
            calls[_name].append((args, kw))
            return _orig(self, *args, **kw)

        monkeypatch.setattr(matplotlib.axes.Axes, name, record)
    v = JaxVisualizer()
    paths = [v.plot_time_series(_results(jax_dto), tmp_path / "j_ts.png"),
             v.plot_zone_statistics(STATS, tmp_path / "j_st.png"),
             v.plot_heatmap(_results(jax_dto), tmp_path / "j_hm.png")]
    monkeypatch.undo()
    return calls, [cv2.imread(str(p)).shape for p in paths]


def test_charts_without_matplotlib_plot_the_jax_series(tmp_path, monkeypatch):
    calls, jax_shapes = _jax_calls(tmp_path, monkeypatch)
    results = _results(port_dto)

    zones, x, series = port_viz.time_series_data(results)
    assert [kw["label"] for _, kw in calls["plot"]] == zones
    for (args, _), zone in zip(calls["plot"], zones):
        assert list(args[0]) == x and list(args[1]) == series[zone]
    zones, avg, mx = port_viz.zone_statistics_data(STATS)
    assert [list(args[1]) for args, _ in calls["bar"]] == [avg, mx]
    assert list(calls["bar"][0][0][0] + 0.2) == list(range(len(zones)))
    _, stamps, matrix = port_viz.heatmap_data(results)
    np.testing.assert_array_equal(calls["imshow"][0][0][0], matrix)
    assert stamps == [r.timestamp for r in results]

    with monkeypatch.context() as m:
        for name in [n for n in sys.modules if n == "matplotlib" or n.startswith("matplotlib.")]:
            m.setitem(sys.modules, name, None)
        v = port_viz.Visualizer()
        paths = [v.plot_time_series(results, tmp_path / "zone_time_series.png"),
                 v.plot_zone_statistics(STATS, tmp_path / "zone_statistics.png"),
                 v.plot_heatmap(results, tmp_path / "zone_heatmap.png")]
    for path, shape in zip(paths, jax_shapes):
        assert path.stat().st_size > 1000
        img = cv2.imread(str(path))
        assert img.shape == shape and img.std() > 10  # drawn, not blank


def test_phase5_writes_the_charts_without_matplotlib(tmp_path, no_matplotlib):
    """``output.save_charts`` on (the default): the three chart files, on a
    machine where matplotlib cannot be imported."""
    cfg = {"output.save_floormap_images": False}
    results = _results(port_dto, n=8)
    made = VisualizationPhase(cfg).execute([], results, tmp_path, zone_statistics=STATS)
    assert sorted(made) == ["heatmap", "statistics", "time_series"]
    for name in ("zone_time_series.png", "zone_statistics.png", "zone_heatmap.png"):
        img = cv2.imread(str(tmp_path / name))
        assert img is not None and img.size > 0, name
