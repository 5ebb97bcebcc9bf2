"""Zone-count aggregation.

Mirrors ``office_person_detection_vit_tpu/aggregation/aggregator.py``: the
per-frame counts of a run, their statistics, trend and peaks
(``ops/aggregation.py`` on the aggregator's device: ``detection.device``
values, the default ``"auto"`` the card, ``"cpu"`` the CPU), and
``zone_counts.csv``.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from ..core.dto import AggregationResult
from ..device import resolve_device
from ..ops import aggregation as agg_ops

UNCLASSIFIED = "unclassified"


class Aggregator:
    def __init__(self, zone_ids: Sequence[str], device: torch.device | str = "auto"):
        self.zone_ids = list(zone_ids)
        self.device = resolve_device(str(device))
        self._timestamps: list[str] = []
        self._rows: list[np.ndarray] = []  # per-frame (Z,) counts
        self._unclassified: list[int] = []

    # ------------------------------------------------------------ ingestion
    def aggregate_frame(self, timestamp: str, zone_ids_per_detection: list[list[str]]) -> AggregationResult:
        """One frame's counts: a detection in k zones counts once in each;
        one in no known zone counts as unclassified."""
        counts = np.zeros(len(self.zone_ids), np.int32)
        uncls = 0
        index = {z: i for i, z in enumerate(self.zone_ids)}
        for zones in zone_ids_per_detection:
            real = [z for z in zones if z in index]
            if not real:
                uncls += 1
            for z in real:
                counts[index[z]] += 1
        self._timestamps.append(timestamp)
        self._rows.append(counts)
        self._unclassified.append(uncls)
        zc = {z: int(c) for z, c in zip(self.zone_ids, counts)}
        if uncls:
            zc[UNCLASSIFIED] = uncls
        return AggregationResult(timestamp=timestamp, zone_counts=zc)

    def aggregate_membership(self, timestamps: list[str], membership, valid) -> None:
        """Many frames at once: (F, Q, Z) membership and (F, Q) valid (host
        arrays, or tensors) reduced on the device."""
        m = torch.as_tensor(membership, dtype=torch.bool).to(self.device)
        v = torch.as_tensor(valid, dtype=torch.bool).to(self.device)
        counts = agg_ops.zone_count_matrix(m, v).cpu().numpy()
        uncls = agg_ops.unclassified_counts(m, v).cpu().numpy()
        self._timestamps.extend(timestamps)
        self._rows.extend(list(counts))
        self._unclassified.extend(int(u) for u in uncls)

    # -------------------------------------------------------------- queries
    @property
    def counts_matrix(self) -> np.ndarray:
        if not self._rows:
            return np.zeros((0, len(self.zone_ids)), np.int32)
        return np.stack(self._rows)

    def _counts(self) -> torch.Tensor:
        return torch.from_numpy(self.counts_matrix).to(self.device)

    def get_zone_counts(self) -> dict[str, dict[str, int]]:
        """{timestamp: {zone_id: count, ..., unclassified: n}}."""
        out: dict[str, dict[str, int]] = {}
        for ts, row, uncls in zip(self._timestamps, self._rows, self._unclassified):
            d = {z: int(c) for z, c in zip(self.zone_ids, row)}
            if uncls:
                d[UNCLASSIFIED] = int(uncls)
            out[ts] = d
        return out

    def get_statistics(self) -> dict[str, dict[str, float]]:
        """Per zone: average, max, min, std, median, q1, q3."""
        if not self._rows:
            return {}
        stats = {k: v.cpu().numpy() for k, v in agg_ops.zone_statistics(self._counts()).items()}
        return {z: {k: float(v[i]) for k, v in stats.items()} for i, z in enumerate(self.zone_ids)}

    def get_trend_analysis(self) -> dict[str, dict[str, float]]:
        """Per zone: least-squares slope, intercept, R^2 and a direction."""
        if len(self._rows) < 2:
            return {}
        trend = {k: v.cpu().numpy() for k, v in agg_ops.linear_trend(self._counts()).items()}
        out = {}
        for i, z in enumerate(self.zone_ids):
            slope = float(trend["slope"][i])
            out[z] = {
                "slope": slope,
                "intercept": float(trend["intercept"][i]),
                "r_squared": float(trend["r_squared"][i]),
                "direction": "increasing" if slope > 0.01 else ("decreasing" if slope < -0.01 else "stable"),
            }
        return out

    def get_peak_times(self, top_n: int = 5) -> list[dict[str, Any]]:
        """The top_n frames of most total occupancy."""
        if not self._rows:
            return []
        idxs, vals = (t.cpu().numpy() for t in agg_ops.top_k_peaks(self._counts(), k=top_n))
        return [{"timestamp": self._timestamps[int(i)], "total_count": int(v)} for i, v in zip(idxs, vals)]

    # --------------------------------------------------------------- export
    def export_csv(self, path: str | Path) -> Path:
        """``zone_counts.csv``: header timestamp,<zones>,unclassified,total,
        one row per frame."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["timestamp", *self.zone_ids, UNCLASSIFIED, "total"])
            for ts, row, uncls in zip(self._timestamps, self._rows, self._unclassified):
                total = int(row.sum()) + int(uncls)
                w.writerow([ts, *[int(c) for c in row], int(uncls), total])
        return path

    def reset(self) -> None:
        self._timestamps = []
        self._rows = []
        self._unclassified = []
