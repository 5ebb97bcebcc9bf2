"""Wrappers of the hand-written CUDA attention kernels (``csrc/attention.cu``).

Counterparts of the Pallas kernels in
``office_person_detection_vit_tpu/ops/attention.py``:

- :func:`attention_whole_kv` replaces ``attention_pallas`` /
  ``_fused_attn_kernel`` (K1): the head's whole K and V in shared memory, an
  exact two-pass softmax;
- :func:`attention_flash` replaces ``attention_pallas_flash`` /
  ``_flash_attn_kernel`` (K2): K/V streamed in 64-key tiles with an online
  softmax.

In bf16 both run QK^T and P.V on the tensor cores (``mma.sync`` m16n8k16, one
warp per 16 query rows; :func:`whole_kv_plan` gives K1's grid); in float32
they keep their CUDA-core body (four threads per query row, 64-row blocks).

The source is compiled with the port's other CUDA sources, in one ``nvcc``
call for ``sm_90a``, into a shared library with a plain C interface at first
use (:func:`load_library`, see ``kernels/build.py``) and bound with
``ctypes``. Importing this module builds nothing, so it imports on machines
without ``nvcc`` or a card.

On a CPU tensor each wrapper runs the plain version
(:func:`~office_person_detection_vit_torch.ops.attention.attention_reference`);
on a CUDA tensor it launches its kernel or raises. There is no fall-back.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.attention import attention_reference
from . import build
from .build import BLOCK_SMEM_BYTES

#: Launches of each kernel since the last :func:`reset_launch_counts`. Each
#: wrapper adds one where it launches its kernel, and nowhere else.
launch_counts = {"attention_whole_kv": 0, "attention_flash": 0}

#: Query rows per block of the float32 kernels (kRows in the source).
QUERY_TILE = 64
#: bf16: query rows per warp (one m16 tile), keys per score tile and most
#: warps of a K1 block (kWarpRows, kTileKeys, and kWholeKvMaxWarps, the
#: launch bounds, in the source).
WARP_ROWS, TILE_KEYS, WHOLE_KV_MAX_WARPS = 16, 64, 16
#: Head dims the source is instantiated for: 16 (tiny, small) and 32 (full).
HEAD_DIMS = (16, 32)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def whole_kv_smem_bytes(lk: int, head_dim: int, dtype: torch.dtype) -> int:
    """Shared memory K1 takes for one block.

    bf16: K and V of one (batch*head) padded to whole 64-key tiles (the pad
    rows are zero-filled), and a float bias per key: at DETR's 920 keys and
    D 32, 2*960*32*2 + 960*4 = 126,720 B. float32: K and V, the 64-row query
    tile and one mask byte per key: 2*920*32*4 + 64*32*4 + 920 = 244,632 B.
    """
    if dtype == torch.bfloat16:
        keys = _ceil(lk, TILE_KEYS) * TILE_KEYS
        return 2 * keys * head_dim * 2 + 4 * keys
    item = torch.empty((), dtype=dtype).element_size()
    return 2 * lk * head_dim * item + QUERY_TILE * head_dim * item + lk


def whole_kv_fits(lk: int, head_dim: int, dtype: torch.dtype) -> bool:
    """Whether one (batch*head)'s K1 block fits in the 227 KB a block can use."""
    return whole_kv_smem_bytes(lk, head_dim, dtype) <= BLOCK_SMEM_BYTES


def whole_kv_plan(lq: int, lk: int, head_dim: int, dtype: torch.dtype) -> dict:
    """K1's launch: query-row blocks per (batch*head) and threads a block,
    which the wrapper passes to the kernel's entry point, and shared bytes a
    block.

    bf16: one warp per 16 query rows; the fewest blocks of at most 16 warps,
    the warps spread evenly over them. Only one block fits on an SM at DETR's
    920 keys (126,720 B), so a block takes as many rows as it can: 920 rows
    are 58 warp tiles, 4 blocks of 15 warps (480 threads); 100 rows (the
    decoder) one block of 7 warps. float32: 64-row blocks of 256 threads.
    """
    if dtype == torch.bfloat16:
        tiles = _ceil(lq, WARP_ROWS)
        blocks = _ceil(tiles, WHOLE_KV_MAX_WARPS)
        threads = 32 * _ceil(tiles, blocks)
    else:
        blocks, threads = _ceil(lq, QUERY_TILE), 4 * QUERY_TILE
    return {"blocks_per_head": blocks, "threads": threads,
            "smem_bytes": whole_kv_smem_bytes(lk, head_dim, dtype)}


def use_flash(lk: int, head_dim: int, dtype: torch.dtype) -> bool:
    """The whole-KV/flash switch, set by an H100 measurement.

    bf16: always K2 (flash). Timed beside each other in ``chip_smoke.py``
    phase 2 (NVIDIA H100 80GB HBM3, 700.00 W; the run PERF.md's attention
    table cites), K2 is faster at all three of DETR-R50's shapes (B 8, H 8,
    D 32): encoder 920x920 0.0577 against K1's 0.0673 ms, cross-attention
    100x920 0.0169 against 0.0223, decoder self-attention 100x100 0.0044
    against 0.0060. K1 pays a second
    exponential per score (it normalizes before rounding, as
    _fused_attn_kernel does) and, with a whole head's K/V in shared memory,
    runs one block an SM.
    float32: K1 where its block fits in the 227 KB a block can use, K2
    otherwise (DETR-R50's 920 keys need 244,632 B; DC5's 3680 more).
    (The JAX package's 8 MB ``_FLASH_BYTES_THRESHOLD`` is a TPU VMEM figure
    and does not apply.)
    """
    return dtype == torch.bfloat16 or not whole_kv_fits(lk, head_dim, dtype)


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels. Raises when there is no card."""
    lib = build.load_library()
    # (dtype, q, k, v, mask, out, B, H, Lq, Lk, D[, blocks, threads], stream)
    head = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    lib.attention_whole_kv.argtypes = head + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.attention_flash.argtypes = head + [ctypes.c_void_p]
    for name in launch_counts:
        getattr(lib, name).restype = ctypes.c_int
    fn = lib.attention_kernel_attributes
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)] + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    return lib


def kernel_attributes() -> list[dict]:
    """Each attention kernel's compiled resources on the card
    (``cudaFuncGetAttributes``): registers a thread, local (spilled) bytes a
    thread, static shared bytes and most threads a block."""
    lib = load_library()
    rows = []
    for i in range(64):
        name = ctypes.c_char_p()
        vals = [ctypes.c_int() for _ in range(4)]
        if lib.attention_kernel_attributes(i, ctypes.byref(name), *map(ctypes.byref, vals)) != 0:
            break
        rows.append(dict(zip(("name", "regs", "local_bytes", "static_smem", "max_threads"),
                             [name.value.decode()] + [x.value for x in vals])))
    return rows


def _check(q, k, v, mask) -> None:
    tensors = (q, k, v)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(
            f"attention kernels take CUDA tensors, got {[str(t.device) for t in tensors]}"
        )
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B,H,Lq,D), k = v (B,H,Lk,D); got {q.shape}, {k.shape}, {v.shape}")
    B, H, Lq, D = q.shape
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if Lq == 0 or k.shape[2] == 0:
        raise ValueError("empty query or key sequence")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("q, k, v must be contiguous and 16-byte aligned")
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != (B, k.shape[2]):
            raise ValueError(f"key_padding_mask must be bool (B, Lk), got {mask.dtype} {tuple(mask.shape)}")
        if mask.device != q.device or not mask.is_contiguous():
            raise ValueError("key_padding_mask must be contiguous on q's device")


def _launch(name: str, q, k, v, mask, *grid: int) -> torch.Tensor:
    _check(q, k, v, mask)
    lib = load_library()
    B, H, Lq, D = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, H, Lq, k.shape[2], D, *grid, stream,
        )
    build.check_launch(lib, name, err)
    launch_counts[name] += 1
    return out


def attention_whole_kv(q, k, v, key_padding_mask=None) -> torch.Tensor:
    """K1: q (B,H,Lq,D), k/v (B,H,Lk,D), mask (B,Lk) bool True = valid."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_padding_mask)
    if not whole_kv_fits(k.shape[2], q.shape[3], q.dtype):
        raise ValueError(
            f"K/V of {k.shape[2]} keys x {q.shape[3]} in {q.dtype} exceed a block's "
            "shared memory; use attention_flash"
        )
    plan = whole_kv_plan(q.shape[2], k.shape[2], q.shape[3], q.dtype)
    return _launch("attention_whole_kv", q, k, v, key_padding_mask, plan["blocks_per_head"], plan["threads"])


def attention_flash(q, k, v, key_padding_mask=None) -> torch.Tensor:
    """K2: same contract as :func:`attention_whole_kv`, any Lk."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_padding_mask)
    return _launch("attention_flash", q, k, v, key_padding_mask)
