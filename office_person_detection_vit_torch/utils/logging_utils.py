"""Logging setup (reference src/utils/logging_utils.py:9-45).

Root logger with console + ``<output_dir>/system.log`` file handlers, DEBUG
level on demand, and idempotent reconfiguration (handlers are reset so the
orchestrator can re-point the file handler into the session output directory
after config load, reference main.py:53-55).

The port's own copy of ``office_person_detection_vit_tpu/utils/logging_utils.py`` (host code, unchanged).
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def setup_logging(
    debug: bool = False, output_dir: str | Path | None = None
) -> logging.Logger:
    """Configure the root logger; returns it.

    Safe to call multiple times — existing handlers are removed first.
    """
    root = logging.getLogger()
    for handler in list(root.handlers):
        root.removeHandler(handler)
        handler.close()

    level = logging.DEBUG if debug else logging.INFO
    root.setLevel(level)
    formatter = logging.Formatter(_FORMAT)

    console = logging.StreamHandler(sys.stdout)
    console.setLevel(level)
    console.setFormatter(formatter)
    root.addHandler(console)

    if output_dir is not None:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        file_handler = logging.FileHandler(out / "system.log", encoding="utf-8")
        file_handler.setLevel(level)
        file_handler.setFormatter(formatter)
        root.addHandler(file_handler)

    return root
