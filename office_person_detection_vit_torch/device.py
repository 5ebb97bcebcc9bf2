"""Device resolution for the port (new; the JAX package leaves it to JAX).

``detection.device`` names the device: ``"auto"`` and ``"cuda"`` (or
``"cuda:N"``) mean the card, ``"cpu"`` the CPU. A request for the card on a
machine without one raises: there is no quiet fall-back to the CPU.
"""

from __future__ import annotations

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
