"""Device resolution for the port (new; the JAX package leaves it to JAX).

``detection.device`` names the device: ``"auto"`` and ``"cuda"`` (or
``"cuda:N"``) mean the card, ``"cpu"`` the CPU. A request for the card on a
machine without one raises: there is no quiet fall-back to the CPU.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any

import torch


def resolve_device(pref: str = "auto", dtype: str = "float32") -> torch.device:
    """Map a ``detection.device`` value to a torch device.

    When ``dtype`` is float32, TF32 is switched off for matmuls and cuDNN
    convolutions (process-wide): cuDNN's flag defaults to True and would
    quietly run float32 convolutions in TF32.
    """
    pref = str(pref).strip().lower()
    if pref == "cpu":
        device = torch.device("cpu")
    elif pref == "auto" or pref == "cuda" or pref.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {pref!r} asks for CUDA, and no CUDA device is available")
        device = torch.device("cuda" if pref == "auto" else pref)
    else:
        raise ValueError(f"unknown device {pref!r} (expected auto, cuda, cuda:N or cpu)")
    if dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def config_device(config: Any) -> str:
    """``detection.device`` of a config (any object with ``.get(key,
    default)``), ``"auto"`` when unset: the one device key of the JAX
    package's config, which every phase of the port reads."""
    return str(config.get("detection.device", "auto"))


@contextmanager
def full_float32():
    """TF32 off for matmuls and cuDNN convolutions inside the block, and the
    caller's settings restored after it.

    Not ``torch.backends.cudnn.flags(allow_tf32=False)``: that context also
    sets every other cuDNN flag to its own defaults, ``enabled=False``
    among them, which takes the convolutions off cuDNN.
    """
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = before
