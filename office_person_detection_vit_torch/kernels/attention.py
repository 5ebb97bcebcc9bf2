"""Wrappers of the hand-written CUDA attention kernels (``csrc/attention.cu``).

Counterparts of the Pallas kernels in
``office_person_detection_vit_tpu/ops/attention.py``:

- :func:`attention_whole_kv` replaces ``attention_pallas`` /
  ``_fused_attn_kernel`` (K1): one block per (batch*head, 64-row query tile)
  with the head's whole K and V in shared memory;
- :func:`attention_flash` replaces ``attention_pallas_flash`` /
  ``_flash_attn_kernel`` (K2): the same grid, streaming K/V in 64-key tiles
  with an online softmax.

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

#: Query rows per block (kRows in the source).
QUERY_TILE = 64
#: Head dims the source is instantiated for: 16 (tiny, small) and 32 (full).
HEAD_DIMS = (16, 32)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def whole_kv_smem_bytes(lk: int, head_dim: int, dtype: torch.dtype) -> int:
    """Shared memory K1 takes for one block: K and V of one (batch*head),
    the 64-row query tile, and one mask byte per key."""
    item = torch.empty((), dtype=dtype).element_size()
    return 2 * lk * head_dim * item + QUERY_TILE * head_dim * item + lk


def use_flash(lk: int, head_dim: int, dtype: torch.dtype) -> bool:
    """The whole-KV/flash switch, re-derived for the H100.

    Whole-KV (K1) when one (batch*head)'s K and V plus a query tile fit in
    the 227 KB a block can use, flash (K2) otherwise. At DETR's encoder
    width (Lk 920, D 32): bf16 needs 2*920*32*2 + 64*32*2 + 920 = 122,776 B
    and takes K1; float32 needs 2*920*32*4 + 64*32*4 + 920 = 244,632 B and
    takes K2; DC5's 3680 keys take K2 in either type. (The JAX package's
    8 MB ``_FLASH_BYTES_THRESHOLD`` is a TPU VMEM figure and does not apply.)
    """
    return whole_kv_smem_bytes(lk, head_dim, dtype) > BLOCK_SMEM_BYTES


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels. Raises when there is no card."""
    lib = build.load_library()
    args = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    for name in launch_counts:
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


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


def _launch(name: str, q, k, v, mask) -> torch.Tensor:
    _check(q, k, v, mask)
    lib = load_library()
    B, H, Lq, D = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, H, Lq, k.shape[2], D, stream,
        )
    build.check_launch(lib, name, err)
    launch_counts[name] += 1
    return out


def attention_whole_kv(q, k, v, key_padding_mask=None) -> torch.Tensor:
    """K1: q (B,H,Lq,D), k/v (B,H,Lk,D), mask (B,Lk) bool True = valid."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_padding_mask)
    if use_flash(k.shape[2], q.shape[3], q.dtype):
        raise ValueError(
            f"K/V of {k.shape[2]} keys x {q.shape[3]} in {q.dtype} exceed a block's "
            "shared memory; use attention_flash"
        )
    return _launch("attention_whole_kv", q, k, v, key_padding_mask)


def attention_flash(q, k, v, key_padding_mask=None) -> torch.Tensor:
    """K2: same contract as :func:`attention_whole_kv`, any Lk."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_padding_mask)
    return _launch("attention_flash", q, k, v, key_padding_mask)
