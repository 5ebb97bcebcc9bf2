"""The port's entry point (reference main.py:20-136).

Mirrors the repo's root ``main.py``: argparse -> config -> logging ->
orchestrate the phases -> summary. Run it as

    python -m office_person_detection_vit_torch --config config.yaml

It runs on the card (``detection.device`` ``auto`` or ``cuda``; no card
raises) unless the config asks for ``cpu``. Exit codes: 0 ok, 1 config
error, 2 runtime error, 130 SIGINT (reference main.py:120-131); a failed or
cancelled run still writes its ``summary.json``.

What the port does not have yet is refused with ``NotImplementedError``
before any session directory is written, and the run exits 2: ``--evaluate``
(ROADMAP A.3), ``--fine-tune`` (A.6), and the config keys of
``pipeline.orchestrator.UNPORTED_KEYS`` (tracking A.5, multi-host A.8, the
side-by-side video A.3). There is no compile cache to enable: the CUDA
kernels are built once into ``_build/``.
"""

from __future__ import annotations

import logging
import sys

from .cli.arguments import parse_arguments
from .config.config_manager import ConfigManager, ConfigValidationError
from .pipeline.orchestrator import PipelineOrchestrator
from .utils.logging_utils import setup_logging

logger = logging.getLogger(__name__)

#: Command-line flags of the root ``main.py`` that the port refuses, with the
#: ROADMAP item that brings each.
UNPORTED_FLAGS = {
    "evaluate": "--evaluate: detection evaluation (evaluation/) is not ported yet (ROADMAP A.3)",
    "fine_tune": "--fine-tune: detector training is not ported yet (ROADMAP A.6)",
}


def main(argv: list[str] | None = None) -> int:
    args = parse_arguments(argv)
    setup_logging(debug=args.debug)
    orchestrator = None
    try:
        config = ConfigManager(args.config)
        config.validate()
        if args.debug:
            config.set("output.debug_mode", True)
        # Re-point the file log into the output dir (reference main.py:53-55).
        setup_logging(debug=args.debug, output_dir=config.get("output.directory", "output"))
        for flag, why in UNPORTED_FLAGS.items():
            if getattr(args, flag):
                raise NotImplementedError(why)

        orchestrator = PipelineOrchestrator(config, logging.getLogger("pipeline"))
        start, end = orchestrator.parse_datetime_range(args.start_time, args.end_time)

        result = orchestrator.run(
            start_time=start,
            end_time=end,
            resume_session=args.resume,
            timestamps_only=args.timestamps_only,
        )
        logger.info("pipeline finished: %s", result)
        return 0
    except (ConfigValidationError, FileNotFoundError) as e:
        logger.error("configuration error: %s", e)
        return 1
    except KeyboardInterrupt:
        logger.warning("interrupted")
        if orchestrator is not None:
            try:
                orchestrator.save_session_summary(status="cancelled")
            except Exception:
                pass  # interrupted before the session existed
        return 130
    except Exception:
        logger.exception("pipeline failed")
        if orchestrator is not None:
            try:
                orchestrator.save_session_summary(status="failed")
            except Exception:
                pass
        return 2
    finally:
        if orchestrator is not None:
            orchestrator.cleanup()


if __name__ == "__main__":
    sys.exit(main())
