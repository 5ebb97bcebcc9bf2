"""Pipeline checkpointing (reference src/utils/checkpoint_manager.py:16-210).

Writes ``pipeline_checkpoint.json`` per session with per-phase
``{status, timestamp, data}`` entries (schema
schemas/pipeline_checkpoint.schema.json, phase keys ``^[0-9]{2}_[a-z]+$``).

Unlike the reference — where the resume query API exists but main.py never
consumes it (SURVEY.md §5.4) — this framework's orchestrator actually resumes
from ``get_resumable_phase()``.

The port's own copy of ``office_person_detection_vit_tpu/utils/checkpoint_manager.py`` (host code, unchanged).
"""

from __future__ import annotations

import json
import logging
from datetime import datetime
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)

CHECKPOINT_FILENAME = "pipeline_checkpoint.json"

#: Canonical phase order (keys used in the checkpoint file).
PHASE_ORDER = [
    "01_extraction",
    "02_detection",
    "03_tracking",
    "04_transform",
    "05_aggregation",
    "06_visualization",
]

STATUS_COMPLETED = "completed"
STATUS_FAILED = "failed"
STATUS_IN_PROGRESS = "in_progress"
STATUS_SKIPPED = "skipped"


class CheckpointManager:
    def __init__(self, session_dir: str | Path):
        self.session_dir = Path(session_dir)
        self.path = self.session_dir / CHECKPOINT_FILENAME
        self._state: dict[str, Any] = {
            "session_dir": str(self.session_dir),
            "created_at": datetime.now().isoformat(),
            "last_updated": None,
            "last_phase": None,
            "phases": {},
        }
        if self.path.exists():
            try:
                self._state = json.loads(self.path.read_text(encoding="utf-8"))
            except (OSError, json.JSONDecodeError) as e:
                logger.warning("could not load checkpoint %s: %s", self.path, e)

    # ----------------------------------------------------------------- write
    def save_phase(
        self, phase: str, status: str = STATUS_COMPLETED, data: dict | None = None
    ) -> None:
        self._state["phases"][phase] = {
            "status": status,
            "timestamp": datetime.now().isoformat(),
            "data": data or {},
        }
        self._state["last_updated"] = datetime.now().isoformat()
        if status == STATUS_COMPLETED:
            self._state["last_phase"] = phase
        self._flush()

    def _flush(self) -> None:
        self.session_dir.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".json.tmp")
        tmp.write_text(
            json.dumps(self._state, indent=2, ensure_ascii=False, default=str),
            encoding="utf-8",
        )
        tmp.replace(self.path)

    # ----------------------------------------------------------------- query
    def get_phase_status(self, phase: str) -> str | None:
        entry = self._state["phases"].get(phase)
        return entry["status"] if entry else None

    def get_phase_data(self, phase: str) -> dict[str, Any]:
        entry = self._state["phases"].get(phase)
        return dict(entry.get("data", {})) if entry else {}

    def is_completed(self, phase: str) -> bool:
        return self.get_phase_status(phase) == STATUS_COMPLETED

    def get_last_completed_phase(self) -> str | None:
        last = None
        for phase in PHASE_ORDER:
            if self.is_completed(phase):
                last = phase
        return last

    def get_resumable_phase(self) -> str | None:
        """First phase in canonical order not yet completed (None = all done)."""
        for phase in PHASE_ORDER:
            if not self.is_completed(phase):
                return phase
        return None

    def summary(self) -> dict[str, Any]:
        return {
            "last_phase": self._state.get("last_phase"),
            "phases": {
                k: v["status"] for k, v in self._state.get("phases", {}).items()
            },
        }
