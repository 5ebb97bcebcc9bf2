"""Build and load the port's CUDA kernels: every ``csrc/*.cu`` source
compiled by an ``nvcc`` of its own, all started together, for ``sm_90a``,
then linked into one shared library with a plain C interface, bound with
``ctypes``.

The library is cached under ``_build/`` by a hash of every source, every
header they include (``csrc/*.cuh``) and the flags (:func:`digest`), so
the first caller in a process builds it and every wrapper module
(``kernels/attention.py``, ``kernels/bottleneck.py``) shares it. Importing
this module builds nothing, so it imports on machines without ``nvcc`` or a
card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

#: Shared memory one block may use on sm_90 (227 KB, opt-in dynamic).
BLOCK_SMEM_BYTES = 232_448

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    """The compiled sources, one nvcc input each."""
    return sorted(CSRC.glob("*.cu"))


def digest(csrc: Path = CSRC, flags: tuple[str, ...] = NVCC_FLAGS) -> str:
    """Hash of the flags and of every ``*.cu`` and ``*.cuh`` under ``csrc``:
    a changed header builds a new library as a changed source does."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels cannot be built")


def build_library(defines: tuple[str, ...] = ()) -> Path:
    """Compile every ``csrc/*.cu`` (cached) -> .so path: one ``nvcc -c`` a
    source, all running at once, then one ``nvcc -shared`` link. ``defines``
    (``-D`` flags) builds a variant of the library, such as the fused
    bottleneck's phase profile, cached under its own key."""
    srcs = sources()
    flags = (*NVCC_FLAGS, *defines)
    target = BUILD_DIR / f"libkernels_{digest(flags=flags)}.so"
    if target.exists():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", str(obj), str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for src, obj in zip(srcs, objs)]
        failed = []
        for src, proc in zip(srcs, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = Path(tmp) / "libkernels.so"
        proc = subprocess.run([nvcc, *flags, "-shared", "-o", str(lib), *map(str, objs)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, target)
    return target


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels. Raises when there is no card."""
    global _lib
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device; none is available")
    lib = ctypes.CDLL(str(build_library()))
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def refuse_autograd(name: str, *tensors) -> None:
    """Raise where a kernel would drop autograd: the kernels fill their
    output through ctypes, so it has no ``grad_fn``. Under ``no_grad`` or
    ``inference_mode`` (the detect path, and the forward of an autograd
    Function), or with no input that requires grad, nothing is refused.
    Attention has a backward through ``ops.attention.multi_head_attention``
    (ROADMAP B.4); the fused bottleneck has none, as in the JAX package."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the CUDA kernel has no backward of its own; its "
            "output would carry no gradient (ROADMAP B.4: attention is differentiable through "
            "ops.attention.multi_head_attention, the fused bottleneck is not). Run it under "
            "torch.no_grad() or torch.inference_mode()."
        )


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.cuda_error_string(err).decode()}")
