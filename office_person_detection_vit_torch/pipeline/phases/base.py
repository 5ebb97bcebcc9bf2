"""The phase contract (mirrors ``office_person_detection_vit_tpu/pipeline/phases/base.py``)."""

from __future__ import annotations

import abc
import logging
from typing import Any


class BasePhase(abc.ABC):
    """A pipeline phase: ``execute`` and ``cleanup``, with a logged banner.

    ``config`` is any object with ``.get(dotted_key, default)``: the JAX
    package's ``ConfigManager``, or a dict of dotted keys.
    """

    #: Checkpoint key of the phase, such as "02_detection".
    name: str = ""

    def __init__(self, config: Any, logger: logging.Logger | None = None):
        self.config = config
        self.logger = logger or logging.getLogger(f"{self.__class__.__module__}.{self.__class__.__name__}")

    def log_banner(self) -> None:
        self.logger.info("=" * 60)
        self.logger.info("Phase %s", self.name or self.__class__.__name__)
        self.logger.info("=" * 60)

    @abc.abstractmethod
    def execute(self, *args: Any, **kwargs: Any) -> Any:
        """Run the phase; returns its artifacts."""

    def cleanup(self) -> None:  # noqa: B027 - optional hook
        """Release the phase's resources (models, buffers). Default: nothing."""
