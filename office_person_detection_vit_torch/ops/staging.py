"""Host staging of the I420 transfer routes: ``csrc/staging.cpp`` bound with
``ctypes``.

The host half of ``office_person_detection_vit_tpu/ops/preprocessing.py``'s
I420 routes (``bgr_to_i420`` :76-104, ``i420_delta_encode`` :152-176) and of
its native library (``native/staging.cpp``, ``native/__init__.py``), which
the port keeps its own copy of. The source is built at first use with ``g++``
into ``_build/`` (keyed by a hash of the source and the flags), apart from the
CUDA library, so it builds on a machine without ``nvcc`` too. A failed build
raises: the detect path does not fall back to another converter.

The plain twins, :func:`bgr_to_i420_reference` (``cv2.cvtColor(...,
COLOR_BGR2YUV_I420)`` frame by frame) and :func:`i420_delta_encode_reference`
(numpy XOR), give the same bytes; the tests hold the library against them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "staging.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0" + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"staging_{h}.so"


def build_library() -> Path:
    """Compile ``csrc/staging.cpp`` (once per source and flags) and return the
    library's path. Raises when there is no C++ compiler or the build fails."""
    path = library_path()
    if path.exists():
        return path
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError("g++ not found: the I420 staging library (csrc/staging.cpp) cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build beside the target and rename, so that a process building at the
    # same time never loads a half-written file.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        done = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", tmp], capture_output=True, text=True,
                              timeout=300)
        if done.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n{done.stderr[-4000:]}")
        os.replace(tmp, path)
    finally:
        Path(tmp).unlink(missing_ok=True)
    return path


def load_library() -> ctypes.CDLL:
    """Build (once) and load the staging library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        lib.opdv_bgr_to_i420.argtypes = [u8p, i64, i64, i64, u8p, ctypes.c_int]
        lib.opdv_i420_delta.argtypes = [u8p, u8p, i64, i64]
        for fn in (lib.opdv_bgr_to_i420, lib.opdv_i420_delta):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def check_i420_geometry(H: int, W: int) -> None:
    """The device decode splits the chroma block as (2, H/4, W): H % 4 and W % 2
    must be 0 (cv2 itself needs only even H)."""
    if H % 4 or W % 2:
        raise ValueError(f"i420 transfer needs H%4==0 and W%2==0, got {H}x{W}; "
                         "use detection.transfer_format=bgr for this input")


def bgr_to_i420(frames: np.ndarray) -> np.ndarray:
    """(F, H, W, 3) uint8 BGR -> (F, H*3//2, W) uint8 I420, byte-identical to
    ``cv2.COLOR_BGR2YUV_I420``, one thread a frame."""
    frames = np.ascontiguousarray(frames, np.uint8)
    F, H, W, _ = frames.shape
    check_i420_geometry(H, W)
    out = np.empty((F, H * 3 // 2, W), np.uint8)
    threads = max(1, min(F, os.cpu_count() or 1))
    if load_library().opdv_bgr_to_i420(_u8p(frames), F, H, W, _u8p(out), threads):
        raise ValueError(f"opdv_bgr_to_i420 refused frames of shape {frames.shape}")
    return out


def i420_delta_encode(planes: np.ndarray, prev_last: np.ndarray) -> np.ndarray:
    """XOR delta of (F, H*3//2, W) I420 frames: frame f XOR frame f - 1, and
    frame 0 XOR ``prev_last`` (the previous chunk's last frame, zeros for the
    first). The caller's array is kept."""
    out = np.array(planes, np.uint8, order="C", copy=True)
    prev = np.ascontiguousarray(prev_last, np.uint8)
    if out.ndim != 3 or prev.shape != out.shape[1:]:
        raise ValueError(f"prev_last {prev.shape} must be one frame of {out.shape}")
    if load_library().opdv_i420_delta(_u8p(out), _u8p(prev), out.shape[0], int(out[0].size)):
        raise ValueError(f"opdv_i420_delta refused planes of shape {out.shape}")
    return out


def bgr_to_i420_reference(frames: np.ndarray) -> np.ndarray:
    """The plain twin of :func:`bgr_to_i420`: ``cv2.cvtColor`` frame by frame."""
    import cv2

    check_i420_geometry(*frames.shape[1:3])
    return np.stack([cv2.cvtColor(np.ascontiguousarray(f), cv2.COLOR_BGR2YUV_I420) for f in frames])


def i420_delta_encode_reference(planes: np.ndarray, prev_last: np.ndarray) -> np.ndarray:
    """The plain twin of :func:`i420_delta_encode`, in numpy."""
    deltas = np.array(planes, np.uint8, copy=True)
    deltas[1:] ^= planes[:-1]
    deltas[0] ^= np.asarray(prev_last, np.uint8)
    return deltas
