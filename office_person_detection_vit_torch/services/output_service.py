"""Session/output service (reference src/services/output_service.py:24-56).

Thin facade over :class:`OutputManager` giving the orchestrator one object to
set up the session, resolve phase directories, and persist metadata/summary.

The port's own copy of ``office_person_detection_vit_tpu/services/output_service.py`` (host code, unchanged).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

from ..utils.output_manager import OutputManager


class OutputService:
    def __init__(self, base_dir: str | Path = "output"):
        self.manager = OutputManager(base_dir)

    def setup(
        self, config: dict[str, Any], session_id: str | None = None
    ) -> Path:
        """Create the session and write metadata.json; returns session dir.
        Applies the session retention policy (output.session.archive_days /
        delete_archive_days) before creating the new session."""
        session_cfg = ((config.get("output") or {}).get("session") or {}) if isinstance(config, dict) else {}
        # Retention only runs when the user config opts in with an
        # output.session section — never silently delete with defaults.
        if session_cfg:
            try:
                self.manager.archive_old_sessions(
                    archive_days=int(session_cfg.get("archive_days", 30)),
                    delete_archive_days=int(session_cfg.get("delete_archive_days", 90)),
                )
            except OSError as e:  # retention must never block a run
                import logging

                logging.getLogger(__name__).warning("session archiving failed: %s", e)
        session_dir = self.manager.create_session(session_id)
        self.manager.save_metadata(config)
        # Persist the RESOLVED config into the session: reproducibility, and
        # the dashboard / GT editor re-instantiate the session's transformer
        # from it (reference dashboard_app.py:154-200).
        try:
            import yaml

            (session_dir / "config.yaml").write_text(
                yaml.safe_dump(config, sort_keys=False), encoding="utf-8"
            )
        except Exception as e:  # non-fatal: config may hold odd types
            import logging

            logging.getLogger(__name__).warning("could not persist config: %s", e)
        return session_dir

    def attach(self, session_dir: str | Path) -> Path:
        """Attach to an existing session (resume path) without recreating it."""
        session_dir = Path(session_dir)
        self.manager.session_dir = session_dir
        self.manager.session_id = session_dir.name
        return session_dir

    @property
    def session_dir(self) -> Path | None:
        return self.manager.session_dir

    @property
    def session_id(self) -> str | None:
        return self.manager.session_id

    def get_phase_dir(self, phase: str) -> Path:
        return self.manager.get_phase_dir(phase)

    def save_summary(self, summary: dict[str, Any]) -> Path:
        return self.manager.save_summary(summary)
