"""Session artifact loading for the dashboard (reference
src/visualization/dashboard_utils.py:30-221).

Mirrors ``office_person_detection_vit_tpu/visualization/dashboard_utils.py``.
Pure file readers over a session directory — metadata.json, summary.json,
pipeline_checkpoint.json, per-phase CSV/JSON artifacts, image listings.
No pipeline imports beyond the transform facade (for on-the-fly track
projection, on ``device``: the card unless asked for the CPU); usable
standalone (tests) or from the Streamlit app.
"""

from __future__ import annotations

import csv
import json
import logging
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)


class SessionDataLoader:
    def __init__(self, session_dir: str | Path, device: str = "auto"):
        self.session_dir = Path(session_dir)
        self.device = device

    # --------------------------------------------------------------- roots
    @staticmethod
    def list_sessions(base_dir: str | Path) -> list[str]:
        base = Path(base_dir)
        if not base.exists():
            return []
        return sorted(
            (
                p.name
                for p in base.iterdir()
                if p.is_dir() and not p.is_symlink() and (p / "metadata.json").exists()
            ),
            reverse=True,
        )

    def _read_json(self, rel: str) -> dict[str, Any] | None:
        path = self.session_dir / rel
        if not path.exists():
            return None
        try:
            return json.loads(path.read_text(encoding="utf-8"))
        except (OSError, json.JSONDecodeError) as e:
            logger.warning("could not read %s: %s", path, e)
            return None

    # ------------------------------------------------------------ artifacts
    def metadata(self) -> dict[str, Any] | None:
        return self._read_json("metadata.json")

    def summary(self) -> dict[str, Any] | None:
        return self._read_json("summary.json")

    def checkpoint(self) -> dict[str, Any] | None:
        return self._read_json("pipeline_checkpoint.json")

    def phase_status(self) -> dict[str, str]:
        cp = self.checkpoint() or {}
        return {k: v.get("status", "?") for k, v in cp.get("phases", {}).items()}

    def extraction_results(self) -> list[dict[str, str]]:
        path = self.session_dir / "01_extraction" / "extraction_results.csv"
        if not path.exists():
            return []
        with path.open() as f:
            return list(csv.DictReader(f))

    def detection_statistics(self) -> dict[str, Any] | None:
        return self._read_json("02_detection/detection_statistics.json")

    def tracking_statistics(self) -> dict[str, Any] | None:
        return self._read_json("03_tracking/tracking_statistics.json")

    def tracks(self) -> dict[str, Any] | None:
        return self._read_json("03_tracking/tracks.json")

    def transformations(self) -> dict[str, Any] | None:
        return self._read_json("04_transform/coordinate_transformations.json")

    def zone_counts(self) -> tuple[list[str], list[dict[str, Any]]]:
        """(zone column names, rows) from zone_counts.csv."""
        path = self.session_dir / "05_aggregation" / "zone_counts.csv"
        if not path.exists():
            return [], []
        with path.open() as f:
            reader = csv.DictReader(f)
            rows = list(reader)
            zones = [c for c in (reader.fieldnames or []) if c != "timestamp"]
        return zones, rows

    def images(self, phase: str, limit: int | None = None) -> list[Path]:
        phase_dir = self.session_dir / phase
        if not phase_dir.exists():
            return []
        out = sorted(
            p for p in phase_dir.rglob("*") if p.suffix in (".jpg", ".png")
        )
        return out[:limit] if limit else out

    # ------------------------------------------------------------- projection
    def floor_trajectories(self) -> dict[int, list[tuple[float, float]]]:
        """Per-track floor-space polylines from the transform artifact;
        when Phase 3 hasn't run but tracks exist, re-project camera-space
        tracks live through the session's homography (reference
        dashboard_app.py:154-200 on-the-fly transformer load)."""
        doc = self.transformations()
        traj: dict[int, list[tuple[float, float]]] = {}
        if not doc:
            return self._project_tracks_live()
        for frame in doc.get("frames", []):
            for d in frame.get("detections", frame.get("det", [])):
                tid = d.get("track_id", d.get("id"))
                floor = d.get("floor_coords_px") or d.get("floor_px")
                if tid is None or floor is None:
                    continue
                pt = (
                    (floor["x"], floor["y"])
                    if isinstance(floor, dict)
                    else (floor[0], floor[1])
                )
                traj.setdefault(int(tid), []).append(pt)
        return traj

    def _project_tracks_live(self) -> dict[int, list[tuple[float, float]]]:
        """Fallback: project tracks.json foot points through the homography
        found in the session's saved config (reference's live transformer
        instantiation, dashboard_app.py:154-200)."""
        import numpy as np

        tracks_doc = self.tracks()
        if not tracks_doc:
            return {}
        matrix = None
        cfg_path = self.session_dir / "config.yaml"
        if cfg_path.exists():
            import yaml

            cfg = yaml.safe_load(cfg_path.read_text()) or {}
            matrix = (cfg.get("homography") or {}).get("matrix")
        if matrix is None:
            return {}
        from ..transform.homography import HomographyTransformer

        transformer = HomographyTransformer(np.asarray(matrix, np.float64), device=self.device)
        traj: dict[int, list[tuple[float, float]]] = {}
        for t in tracks_doc.get("tracks", []):
            feet = np.asarray(
                [
                    (p["bbox"][0] + p["bbox"][2] / 2.0, p["bbox"][1] + p["bbox"][3])
                    for p in t.get("trajectory", [])
                    if "bbox" in p
                ],
                np.float32,
            )
            if not len(feet):
                continue
            floor = np.asarray(transformer.transform_batch(feet))
            traj[int(t["track_id"])] = [(float(x), float(y)) for x, y in floor]
        return traj


# ---------------------------------------------------------- training runs
def list_training_runs(base_dir: str | Path) -> list[str]:
    """Checkpoint directories under ``base_dir`` that carry a trainer
    ``history.json`` (tools/train_detr.py), newest first."""
    base = Path(base_dir)
    if not base.is_dir():
        return []
    runs = [p for p in base.iterdir() if (p / "history.json").is_file()]
    runs.sort(key=lambda p: (p / "history.json").stat().st_mtime,
              reverse=True)
    return [p.name for p in runs]


def load_training_history(run_dir: str | Path) -> dict[str, Any] | None:
    """The trainer's history.json (step/epoch losses, config, evals), or
    None when unreadable."""
    path = Path(run_dir) / "history.json"
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        logger.warning("unreadable training history %s", path)
        return None


def training_summary(history: dict[str, Any]) -> dict[str, Any]:
    """KPI row for a training run: steps, first/last/best epoch loss, the
    best eval F1/mAP when the run evaluated, and the recipe knobs."""
    epochs = [e for e in history.get("epoch_losses", []) if e is not None]
    evals = history.get("evals", [])
    cfg = history.get("config", {})
    out: dict[str, Any] = {
        "steps": len(history.get("step_losses", [])),
        "epochs": len(epochs),
        "first_loss": epochs[0] if epochs else None,
        "last_loss": epochs[-1] if epochs else None,
        "best_loss": min(epochs) if epochs else None,
        "resumed_at_step": history.get("resumed_at_step"),
        # Show only non-default knobs. Identity-aware: `True == 1` in
        # Python, so a naive `not in (..., 1)` would hide augment=True.
        "recipe": {
            k: v
            for k, v in ((k, cfg.get(k)) for k in (
                "schedule", "warmup_steps", "accum_steps", "ema", "augment"))
            if not (v is None or v is False
                    or (not isinstance(v, bool)
                        and v in ("none", 0, 0.0, 1)))
        },
    }
    if evals:
        out["best_f1"] = max(e.get("f1_score", 0.0) for e in evals)
        out["best_map"] = max(e.get("map_50_95", 0.0) for e in evals)
        out["evals"] = len(evals)
    return out
