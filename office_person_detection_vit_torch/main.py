"""The port's entry point (reference main.py:20-136).

Mirrors the repo's root ``main.py``: argparse -> config -> logging ->
orchestrate the phases -> summary. Run it as

    python -m office_person_detection_vit_torch --config config.yaml

It runs on the card (``detection.device`` ``auto`` or ``cuda``; no card
raises) unless the config asks for ``cpu``. Exit codes: 0 ok, 1 config
error, 2 runtime error, 130 SIGINT (reference main.py:120-131); a failed or
cancelled run still writes its ``summary.json``.

``--evaluate`` scores the run's detections against
``evaluation.ground_truth_path`` after the pipeline
(``evaluation.evaluation_module.run_evaluation``), as the root ``main.py``
does. ``--fine-tune`` hands off to the port's trainer (``train_detr.main``) with the
argument list the root ``main.py`` builds from the ``training.*`` keys
(:func:`fine_tune_args`; ``training.model: yolo`` with
``training.yolo_variant``), plus ``--device`` from ``detection.device`` when
the config sets it, and returns its exit code. ``parallel.distributed.enabled``
starts the process group from ``parallel.distributed.{coordinator_address,
num_processes,process_id}`` before Phase 1 (or the trainer), as the root
``main.py`` does (``parallel.mesh.initialize_distributed``).

What the port does not have yet is refused with ``NotImplementedError``
before any session directory is written, and the run exits 2: the config
keys of ``pipeline.orchestrator.UNPORTED_KEYS`` (the side-by-side video and
the attention maps, A.3). There is no compile cache to enable: the CUDA
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

def fine_tune_args(config) -> list[str]:
    """The trainer's argument list from the ``training.*`` keys, as the root
    ``main.py`` builds it (reference --fine-tune path, main.py:20-136)."""
    train_args = [
        "--images", str(config.get("training.images_dir", "data/train/images")),
        "--annotations", str(config.get("training.annotations", "data/train/coco.json")),
        "--epochs", str(config.get("training.epochs", 10)),
        "--batch", str(config.get("training.batch_size", 8)),
        "--checkpoint", str(config.get("training.output_dir", "runs/detr_ft")),
        "--height", str(config.get("training.input_height", 768)),
        "--width", str(config.get("training.input_width", 1344)),
        "--lr", str(config.get("training.learning_rate", 1e-4)),
        "--model", str(config.get("training.model", "detr")),
        "--model-parallel", str(config.get("training.model_parallel", 1)),
    ]
    if config.get("training.model", "detr") == "yolo":
        train_args += ["--yolo-variant", str(config.get("training.yolo_variant", "s"))]
    if config.get("training.tiny", False):
        train_args += ["--tiny"]
    if config.get("training.remat", False):
        train_args += ["--remat"]
    # A present-but-null YAML key means "default" (config.get falls back
    # only for missing keys).
    schedule = config.get("training.schedule", None)
    if schedule and schedule != "none":
        train_args += ["--schedule", str(schedule)]
        drop_at = config.get("training.drop_at", None)
        if drop_at is not None:
            train_args += ["--drop-at", str(drop_at)]
    warmup = int(config.get("training.warmup_steps", 0) or 0)
    if warmup > 0:
        train_args += ["--warmup-steps", str(warmup)]
    accum = int(config.get("training.accum_steps", 1) or 1)
    if accum > 1:
        train_args += ["--accum-steps", str(accum)]
    ema = float(config.get("training.ema", 0.0) or 0.0)
    if ema > 0:
        train_args += ["--ema", str(ema)]
    if config.get("training.augment", False):
        train_args += ["--augment"]
    init = config.get("detection.checkpoint_path", None)
    if init:
        train_args += ["--init", str(init)]
    if config.get("training.evaluate", False):
        train_args += [
            "--evaluate",
            "--eval-every", str(config.get("training.eval_every", 0)),
            "--eval-conf", str(config.get("training.eval_confidence", 0.25)),
        ]
        val_images = config.get("training.val_images_dir", None)
        val_ann = config.get("training.val_annotations", None)
        if val_images:
            train_args += ["--val-images", str(val_images)]
        if val_ann:
            train_args += ["--val-annotations", str(val_ann)]
    return train_args


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
        if config.get("parallel.distributed.enabled", False):
            from .parallel.mesh import initialize_distributed

            initialize_distributed(
                coordinator_address=config.get("parallel.distributed.coordinator_address", None),
                num_processes=config.get("parallel.distributed.num_processes", None),
                process_id=config.get("parallel.distributed.process_id", None),
            )
        if args.fine_tune:
            from .train_detr import main as train_main

            train_args = fine_tune_args(config)
            device = config.get("detection.device", None)
            if device is not None:
                train_args += ["--device", str(device)]
            return train_main(train_args)

        orchestrator = PipelineOrchestrator(config, logging.getLogger("pipeline"))
        start, end = orchestrator.parse_datetime_range(args.start_time, args.end_time)

        result = orchestrator.run(
            start_time=start,
            end_time=end,
            resume_session=args.resume,
            timestamps_only=args.timestamps_only,
        )
        logger.info("pipeline finished: %s", result)

        if args.evaluate:
            from .evaluation.evaluation_module import run_evaluation

            run_evaluation(config, orchestrator.frame_results, orchestrator.output.session_dir)
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
