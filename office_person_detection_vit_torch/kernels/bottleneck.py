"""Wrapper of the hand-written CUDA fused bottleneck (``csrc/bottleneck.cu``).

Counterpart of ``fused_bottleneck`` / ``_kernel`` (K3) in
``office_person_detection_vit_tpu/ops/fused_bottleneck.py``. A block owns
``tile_h`` x ``tile_w`` output pixels and keeps y1 on its haloed ring and y2
in shared memory; :func:`plan` picks ``tile_w`` and the GEMM tile from the
shared-memory budget. The source is built with the port's other CUDA sources
at first use (``kernels/build.py``).

On a CPU tensor :func:`fused_bottleneck` runs the plain version
(:func:`~office_person_detection_vit_torch.ops.fused_bottleneck.bottleneck_reference`);
on a CUDA tensor it launches K3 or raises. There is no fall-back.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.fused_bottleneck import bottleneck_reference
from . import build
from .build import BLOCK_SMEM_BYTES

#: Launches of K3 since the last :func:`reset_launch_counts`; the wrapper
#: adds one where it launches the kernel, and nowhere else.
launch_counts = {"fused_bottleneck": 0}

#: Rows of the kernel's GEMM tile (instantiations of the source), largest
#: first; the tile has 4096 outputs, so its width is 4096 / rows.
GEMM_ROWS = (64, 32, 16)
#: K chunk staged through shared memory per step (kKC in the source).
K_CHUNK = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def smem_bytes(rows: int, tile_h: int, tile_w: int, mid: int, dtype: torch.dtype) -> int:
    """Shared memory of one block: the A and weight chunks (float), y1 on the
    (tile_h+2) x (tile_w+2) ring and y2 on the patch (in x's type)."""
    item = torch.empty((), dtype=dtype).element_size()
    ring = (tile_h + 2) * (tile_w + 2)
    return K_CHUNK * (rows + 4) * 4 + K_CHUNK * (4096 // rows) * 4 + (ring + tile_h * tile_w) * mid * item


def plan(width: int, mid: int, tile_h: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """(gemm rows, tile_w, shared bytes) of a launch.

    A patch is tile_h x (rows // tile_h) pixels, at most the image width. The
    first GEMM tile, largest first, whose block fits in half an SM's shared
    memory wins (two blocks per SM); else the first that fits in a block's
    227 KB. DETR-R50 at 736x1280 in bf16: stage 1 (M 64, tile_h 8) 64 rows,
    8 x 8 pixels, 37,888 B; stage 2 (M 128, tile_h 4) 64 rows, 4 x 16,
    60,928 B; stage 3 (M 256, tile_h 2) 32 rows, 2 x 16, 74,240 B; stage 4
    (M 512, tile_h 1) 16 rows, 1 x 16, 107,008 B.
    """
    for budget in (BLOCK_SMEM_BYTES // 2, BLOCK_SMEM_BYTES):
        for rows in GEMM_ROWS:
            if tile_h > rows:
                continue
            tile_w = min(rows // tile_h, width)
            smem = smem_bytes(rows, tile_h, tile_w, mid, dtype)
            if smem <= budget:
                return rows, tile_w, smem
    raise ValueError(f"no tile of tile_h={tile_h}, M={mid} in {dtype} fits a block's shared memory")


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels. Raises when there is no card."""
    lib = build.load_library()
    lib.fused_bottleneck.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.fused_bottleneck.restype = ctypes.c_int
    return lib


def _check(x, w1, b1, w2, b2, w3, b3) -> None:
    tensors = (x, w1, b1, w2, b2, w3, b3)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"the fused bottleneck takes CUDA tensors, got {[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("x, the weights and the biases must be on one device")
    if x.dtype not in _DTYPE_CODES or any(w.dtype != x.dtype for w in (w1, w2, w3)):
        raise ValueError(f"x and W1-W3 must all be float32 or bfloat16, got {x.dtype}, {w1.dtype}, {w2.dtype}, {w3.dtype}")
    if any(b.dtype != torch.float32 for b in (b1, b2, b3)):
        raise ValueError("the biases must be float32")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    B, H, W, C = x.shape
    M = w1.shape[-1]
    shapes = {"w1": (w1, (C, M)), "b1": (b1, (M,)), "w2": (w2, (3, 3, M, M)), "b2": (b2, (M,)),
              "w3": (w3, (M, C)), "b3": (b3, (C,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want} for x {tuple(x.shape)} and M={M}, got {tuple(t.shape)}")
    if min(B, H, W) == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if C % 8 or M % 8:
        raise ValueError(f"C={C} and M={M} must be multiples of 8 (16-byte vectors)")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("x, the weights and the biases must be contiguous (x NHWC) and 16-byte aligned")


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, *, tile_h: int = 8) -> torch.Tensor:
    """K3: x (B,H,W,C) NHWC, w1 (C,M), w2 (3,3,M,M) HWIO, w3 (M,C) in x's
    type, biases float32; H divisible by tile_h. CPU tensors take the plain
    version."""
    if tile_h < 1 or x.shape[1] % tile_h:
        raise ValueError(f"H={x.shape[1]} not divisible by tile_h={tile_h}")
    if x.device.type == "cpu":
        return bottleneck_reference(x, w1, b1, w2, b2, w3, b3)
    _check(x, w1, b1, w2, b2, w3, b3)
    lib = load_library()
    B, H, W, C = x.shape
    M = w1.shape[1]
    rows, tile_w, _ = plan(W, M, tile_h, x.dtype)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_bottleneck(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
            B, H, W, C, M, tile_h, tile_w, rows, stream,
        )
    build.check_launch(lib, "fused_bottleneck", err)
    launch_counts["fused_bottleneck"] += 1
    return out
