"""CLI flags (reference src/cli/arguments.py:6-35), plus ``--resume``
for the wired checkpoint-resume path.

The port's own copy of ``office_person_detection_vit_tpu/cli/arguments.py`` (the same arguments).
"""

from __future__ import annotations

import argparse


def parse_arguments(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Office person detection pipeline (PyTorch/CUDA port)"
    )
    parser.add_argument(
        "--config", type=str, default="config.yaml", help="config file path"
    )
    parser.add_argument("--debug", action="store_true", help="debug logging")
    parser.add_argument(
        "--evaluate", action="store_true", help="run detection evaluation after the pipeline"
    )
    parser.add_argument(
        "--fine-tune", action="store_true", help="run detector fine-tuning (train_detr) with the training.* config keys"
    )
    parser.add_argument(
        "--start-time", type=str, default=None,
        help="analysis window start, e.g. '2025-01-01 10:00:00'",
    )
    parser.add_argument(
        "--end-time", type=str, default=None,
        help="analysis window end, e.g. '2025-01-01 18:00:00'",
    )
    parser.add_argument(
        "--timestamps-only", action="store_true",
        help="run Phase 1 (timestamp extraction) only",
    )
    parser.add_argument(
        "--resume", type=str, default=None, metavar="SESSION_DIR",
        help="resume a previous session, skipping completed phases",
    )
    return parser.parse_args(argv)
