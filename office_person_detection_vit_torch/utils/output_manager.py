"""Session output management (reference src/utils/output_manager.py:16-193).

The port's own copy of ``office_person_detection_vit_tpu/utils/output_manager.py``.
Each pipeline run is an isolated session directory
``<output>/<YYYYMMDD_HHMMSS>/`` with one numbered subdirectory per phase,
a ``metadata.json`` carrying a reproducibility block (python/platform/git,
plus the torch and CUDA versions and the cards torch sees, where the JAX
package records its JAX backend and devices), and a ``latest`` symlink
pointing at the newest session.
"""

from __future__ import annotations

import json
import logging
import platform
import subprocess
import sys
from datetime import datetime
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)

PHASE_DIRS = [
    "01_extraction",
    "02_detection",
    "03_tracking",
    "04_transform",
    "05_aggregation",
    "06_visualization",
]


def _git_info(cwd: Path) -> dict[str, Any]:
    """Best-effort git commit/branch/dirty (reference output_manager.py:16-70)."""
    info: dict[str, Any] = {}
    try:
        def run(*args: str) -> str:
            return subprocess.run(
                ["git", *args], cwd=cwd, capture_output=True, text=True, timeout=5
            ).stdout.strip()

        commit = run("rev-parse", "HEAD")
        if commit:
            info["git_commit"] = commit
            info["git_branch"] = run("rev-parse", "--abbrev-ref", "HEAD")
            info["git_dirty"] = bool(run("status", "--porcelain"))
    except Exception:  # pragma: no cover - git not available
        pass
    return info


def _torch_info() -> dict[str, Any]:
    """torch and CUDA versions, and the name and count of the cards torch sees."""
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "cuda_device_count": count,
        "cuda_devices": [torch.cuda.get_device_name(i) for i in range(count)],
    }


def reproducibility_info(cwd: Path | None = None) -> dict[str, Any]:
    vi = sys.version_info
    info: dict[str, Any] = {
        "python_version": sys.version,
        "python_version_info": {
            "major": vi.major,
            "minor": vi.minor,
            "micro": vi.micro,
        },
        "platform": platform.platform(),
        "platform_system": platform.system(),
        "platform_machine": platform.machine(),
    }
    info.update(_git_info(cwd or Path.cwd()))
    info.update(_torch_info())
    return info


class OutputManager:
    """Create and manage per-run session directories."""

    def __init__(self, base_dir: str | Path = "output"):
        self.base_dir = Path(base_dir)
        self.session_id: str | None = None
        self.session_dir: Path | None = None

    def create_session(self, session_id: str | None = None) -> Path:
        """Create ``<base>/<session_id>/01_extraction .. 06_visualization``."""
        self.session_id = session_id or datetime.now().strftime("%Y%m%d_%H%M%S")
        self.session_dir = self.base_dir / self.session_id
        for sub in PHASE_DIRS:
            (self.session_dir / sub).mkdir(parents=True, exist_ok=True)
        self._update_latest_symlink()
        logger.info("created session %s at %s", self.session_id, self.session_dir)
        return self.session_dir

    def get_phase_dir(self, phase: str) -> Path:
        """Phase dir by full name ('02_detection') or suffix ('detection')."""
        if self.session_dir is None:
            raise RuntimeError("create_session() has not been called")
        for sub in PHASE_DIRS:
            if sub == phase or sub.split("_", 1)[1] == phase:
                return self.session_dir / sub
        raise KeyError(f"unknown phase: {phase}")

    def save_metadata(self, config: dict[str, Any]) -> Path:
        """Write metadata.json (schema schemas/metadata.schema.json)."""
        if self.session_dir is None:
            raise RuntimeError("create_session() has not been called")
        metadata = {
            "session_id": self.session_id,
            "timestamp": datetime.now().isoformat(),
            "reproducibility": reproducibility_info(),
            "config": config,
        }
        path = self.session_dir / "metadata.json"
        path.write_text(
            json.dumps(metadata, indent=2, ensure_ascii=False, default=str),
            encoding="utf-8",
        )
        return path

    def save_summary(self, summary: dict[str, Any]) -> Path:
        if self.session_dir is None:
            raise RuntimeError("create_session() has not been called")
        path = self.session_dir / "summary.json"
        path.write_text(
            json.dumps(summary, indent=2, ensure_ascii=False, default=str),
            encoding="utf-8",
        )
        return path

    def _update_latest_symlink(self) -> None:
        """Point <base>/latest at the newest session (reference :162-193)."""
        link = self.base_dir / "latest"
        try:
            if link.is_symlink() or link.exists():
                link.unlink()
            link.symlink_to(self.session_dir.name)
        except OSError as e:  # pragma: no cover - fs without symlinks
            logger.debug("could not update latest symlink: %s", e)

    def list_sessions(self) -> list[str]:
        if not self.base_dir.exists():
            return []
        return sorted(
            p.name
            for p in self.base_dir.iterdir()
            if p.is_dir() and not p.is_symlink() and (p / "metadata.json").exists()
        )

    def archive_old_sessions(
        self, archive_days: int = 30, delete_archive_days: int = 90
    ) -> tuple[int, int]:
        """Retention policy the reference's config declares but never
        implements (reference config.yaml:261-262 output.session.archive_days
        / delete_archive_days with no consuming code): sessions older than
        ``archive_days`` move to ``<base>/archive/``; archived sessions older
        than ``delete_archive_days`` are deleted. Session age comes from the
        ``YYYYMMDD_HHMMSS`` directory name; the session the ``latest``
        symlink points at is never archived. Returns (archived, deleted)."""
        import shutil

        now = datetime.now()
        latest_target = None
        link = self.base_dir / "latest"
        if link.is_symlink():
            latest_target = link.resolve().name

        def _age_days(name: str) -> float | None:
            try:
                return (now - datetime.strptime(name, "%Y%m%d_%H%M%S")).total_seconds() / 86400
            except ValueError:
                return None

        archived = deleted = 0
        archive_dir = self.base_dir / "archive"
        for name in self.list_sessions():
            age = _age_days(name)
            if age is None or age <= archive_days or name == latest_target:
                continue
            archive_dir.mkdir(exist_ok=True)
            shutil.move(str(self.base_dir / name), str(archive_dir / name))
            archived += 1
            logger.info("archived session %s (%.0f days old)", name, age)
        if archive_dir.is_dir():
            for p in sorted(archive_dir.iterdir()):
                age = _age_days(p.name)
                if p.is_dir() and age is not None and age > delete_archive_days:
                    shutil.rmtree(p)
                    deleted += 1
                    logger.info("deleted archived session %s (%.0f days old)", p.name, age)
        return archived, deleted
