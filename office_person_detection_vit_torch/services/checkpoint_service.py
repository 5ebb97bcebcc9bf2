"""Checkpoint service (reference src/services/checkpoint_service.py:19-26).

Facade over :class:`CheckpointManager`; unlike the reference, the resume query
is actually consumed by the orchestrator (SURVEY.md §5.4 "resume is designed,
persisted, and unwired" — here it is wired).

The port's own copy of ``office_person_detection_vit_tpu/services/checkpoint_service.py`` (host code, unchanged).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

from ..utils.checkpoint_manager import CheckpointManager


class CheckpointService:
    def __init__(self, session_dir: str | Path):
        self.manager = CheckpointManager(session_dir)

    def save(self, phase: str, status: str = "completed", data: dict | None = None) -> None:
        self.manager.save_phase(phase, status=status, data=data)

    def is_completed(self, phase: str) -> bool:
        return self.manager.is_completed(phase)

    def phase_data(self, phase: str) -> dict[str, Any]:
        return self.manager.get_phase_data(phase)

    def last_completed(self) -> str | None:
        return self.manager.get_last_completed_phase()

    def resumable_phase(self) -> str | None:
        return self.manager.get_resumable_phase()

    def summary(self) -> dict[str, Any]:
        return self.manager.summary()
