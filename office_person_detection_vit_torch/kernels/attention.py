"""Wrappers of the hand-written CUDA attention kernels (``csrc/attention.cu``).

Counterparts of the Pallas kernels in
``office_person_detection_vit_tpu/ops/attention.py``:

- :func:`attention_whole_kv` replaces ``attention_pallas`` /
  ``_fused_attn_kernel`` (K1): the head's whole K and V in shared memory, an
  exact two-pass softmax;
- :func:`attention_flash` replaces ``attention_pallas_flash`` /
  ``_flash_attn_kernel`` (K2): K/V streamed in 64-key tiles with an online
  softmax;
- :func:`attention_backward` is the backward of ``_attention_pallas_diff``
  (B.4), which the JAX package computes by differentiating
  ``attention_reference`` (``_attn_bwd``): a pair of kernels (the end of
  ``csrc/attention.cu``) that recompute the probabilities tile by tile from
  the log-sum-exp the forward wrote (``with_lse=True``), FlashAttention-2's
  scheme: a dQ kernel over query tiles, then a dK/dV kernel over key tiles.

The kernels are instantiated for head dims 16, 32, 64 and 128
(:data:`HEAD_DIMS`). Any other head dim up to 128 is zero-padded to the next
of them on the way in and cut back on the way out (:func:`padded_call`), with
the softmax scale of the true head dim passed to the kernel: zero columns add
nothing to a dot product, so the scores, the log-sum-exp and the kept columns
of every result are those of the unpadded call. Above 128 a head dim is
padded the same way up to the next multiple of :data:`WIDE_CHUNK`, so every
head dim runs: bf16 K2 and the pair take the Hopper bodies at 192 and 256;
every other forward there takes the panel bodies (``attention_panels_*`` in
the source: bf16 on ``wgmma`` and TMA, float32 on register-tiled FP32 FMAs;
at most 256 output columns a block, more in column panels on grid z,
:func:`wide_forward_plan`), and the float32 pair and the bf16 pair above 256
the chunked bodies (``attention_wide_bwd_*``, C.7), which take any such
multiple.

In bf16 the forwards and the backward pair run their products on the tensor
cores: K1 up to head dim 128, and K2 and the pair at head dims 16 and 32, on
``mma.sync`` m16n8k16 (one warp per 16 query or key rows;
:func:`whole_kv_plan` gives K1's grid); K2 at every head dim above 32, K1
above 128 and the pair at head dims 64 to 256 on Hopper's ``wgmma`` with TMA
loads (:func:`is_wgmma_forward`, :func:`is_wgmma_pair`; two warpgroups of 64
rows a block; the library sizes the pair's scratch). In float32 they keep a
CUDA-core body (four threads per row, 64-row blocks; at head dim 128 the
four split the head dim instead of the keys; above 128 the panel body's 16 x
16 threads, each a 4 x 4 block of scores).

The source is compiled beside the port's other CUDA sources (an ``nvcc`` a
source, in parallel) for ``sm_90a`` and linked with them into a shared
library with a plain C interface at first use (:func:`load_library`, see ``kernels/build.py``) and bound with
``ctypes``. Importing this module builds nothing, so it imports on machines
without ``nvcc`` or a card.

On a CPU tensor each forward wrapper runs the plain version
(:func:`~office_person_detection_vit_torch.ops.attention.attention_reference`,
and :func:`~office_person_detection_vit_torch.ops.attention.attention_lse`);
on a CUDA tensor it launches its kernel or raises. There is no fall-back.
:func:`attention_backward` raises on a CPU tensor:
``ops.attention.KernelAttention`` runs its plain version
(``attention_backward_reference``) there itself.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..ops.attention import attention_lse, attention_reference
from . import build
from .build import BLOCK_SMEM_BYTES

#: Launches of each kernel since the last :func:`reset_launch_counts`. Each
#: wrapper adds one where it launches its kernel, and nowhere else.
launch_counts = {"attention_whole_kv": 0, "attention_flash": 0, "attention_backward": 0}
#: The same launches by (wrapper, instantiated head dim), counted at the same
#: place; :func:`reset_launch_counts` leaves them, :func:`reset_head_dim_counts`
#: sets them to 0.
head_dim_counts: dict[tuple[str, int], int] = {}

#: Query rows per block of the float32 kernels (kRows in the source).
QUERY_TILE = 64
#: bf16: query rows per warp (one m16 tile) and keys per score tile
#: (kWarpRows, kTileKeys in the source).
WARP_ROWS, TILE_KEYS = 16, 64
#: Head dims the source is instantiated for: 16 (DETR tiny and small, the
#: tiny ViT), 32 (DETR full), 64 (ViT-base) and 128 (ViT-H's 80 padded, and
#: any head up to 128). Others up to 128 are padded.
HEAD_DIMS = (16, 32, 64, 128)
#: Above 128 a head dim is padded to a multiple of this width (kPanel in the
#: source): the panel bodies stream Q and K in chunks of it above 256, and
#: the chunked backward bodies sum Q.K^T over chunks of it.
WIDE_CHUNK = 64
#: The bf16 backward pair at these instantiated head dims runs the Hopper
#: bodies (``*_wgmma`` in the source: wgmma, TMA, warpgroups); above 256 the
#: chunked ones. bf16 K2 runs a Hopper body at every head dim above 32.
WGMMA_HEAD_DIMS = (64, 128, 192, 256)
#: Most output columns a panel body's block accumulates (kPanelMax); wider
#: heads are cut into column panels on grid z.
PANEL_MAX = 256
#: bf16 panel body: query rows a block and slots of its ring of 64-key items
#: (kWgRows, kPanelStages).
PANEL_BF16_ROWS, PANEL_BF16_STAGES = 128, 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def reset_head_dim_counts() -> None:
    head_dim_counts.clear()


def _count(name: str, head_dim: int) -> None:
    launch_counts[name] += 1
    head_dim_counts[name, head_dim] = head_dim_counts.get((name, head_dim), 0) + 1


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def whole_kv_max_warps(head_dim: int) -> int:
    """Most warps of a bf16 K1 block (``whole_kv_max_warps`` in the source,
    the launch bounds): 16, and 8 at head dim 128, whose thread needs more
    than the 128 registers 16 warps leave it."""
    return 16 if kernel_head_dim(head_dim) <= 64 else 8


def kernel_head_dim(head_dim: int) -> int:
    """The head dim a call of ``head_dim`` runs at: the least of
    :data:`HEAD_DIMS` that holds it, and above 128 the next multiple of
    :data:`WIDE_CHUNK` (192 and 256 are also Hopper bodies in bf16)."""
    if head_dim < 1:
        raise ValueError(f"head dim {head_dim}: must be at least 1")
    for d in HEAD_DIMS:
        if head_dim <= d:
            return d
    return _ceil(head_dim, WIDE_CHUNK) * WIDE_CHUNK


def is_wide(head_dim: int) -> bool:
    """Whether ``head_dim`` is above 128, where every forward but bf16 K2 at
    192 and 256 runs a panel body (:func:`wide_forward_plan`), and the
    float32 pair and the bf16 pair above 256 the chunked bodies."""
    return kernel_head_dim(head_dim) > HEAD_DIMS[-1]


def wide_forward_plan(head_dim: int, dtype: torch.dtype) -> dict:
    """The panel bodies' launch above head dim 128 (``panel_plan`` and
    ``panel_smem_bytes`` in the source, which ``attention_forward_plan``
    exports): a block accumulates at most :data:`PANEL_MAX` output columns,
    so the padded head dim D is cut into ``panels`` = ceil(D / 256) column
    panels on grid z of ``panel_cols`` = ceil(D / panels / 16) * 16 columns
    each (``widths``: the last takes the rest), a block accumulating
    ``acc_cols`` = ceil(panel_cols / 64) * 64 of them. Q stays in shared
    memory when there is one panel (D <= 256) and streams through the ring
    in 64-column chunks beside K above it, so ``smem_bytes`` does not grow
    with D beyond 256's, nor with Lk.

    bf16 (128 query rows a block): Q, 128 rows x D x 2 B, when it stays; 4
    ring slots of acc_cols / 64 x 8 KB; a 64-float key bias a slot; 9
    mbarriers; 1 KB for the 1024-byte alignment. float32 (64 rows): Q, 64
    rows of D + 4 floats, when it stays; 2 slots of 64 rows of acc_cols + 4
    floats; the tile's p, 64 x 68 floats.
    """
    d = kernel_head_dim(head_dim)
    if d <= HEAD_DIMS[-1]:
        raise ValueError(f"head dim {head_dim} runs no panel body (those take head dims above 128)")
    panels = _ceil(d, PANEL_MAX)
    cols = _ceil(_ceil(d, panels), 16) * 16
    widths = [cols] * (panels - 1) + [d - (panels - 1) * cols]
    if widths[-1] <= 0:
        raise ValueError(f"head dim {head_dim}: no panel plan")
    acc = _ceil(cols, WIDE_CHUNK) * WIDE_CHUNK
    resident = panels == 1
    if dtype == torch.bfloat16:
        np_ = acc // WIDE_CHUNK
        smem = ((np_ * PANEL_BF16_ROWS * 128 if resident else 0) + PANEL_BF16_STAGES * np_ * 64 * 128
                + PANEL_BF16_STAGES * 64 * 4 + 8 * (1 + 2 * PANEL_BF16_STAGES) + 1024)
        rows = PANEL_BF16_ROWS
    else:
        smem = ((QUERY_TILE * (d + 4) if resident else 0) + 2 * QUERY_TILE * (acc + 4) + QUERY_TILE * 68) * 4
        rows = QUERY_TILE
    return {"head_dim": d, "panels": panels, "panel_cols": cols, "widths": widths, "acc_cols": acc,
            "query_rows": rows, "smem_bytes": smem}


def padded_call(fn, q, k, v, *like_q):
    """Call ``fn(q, k, v, *like_q, scale=1/sqrt(D))`` with every tensor's
    last dim zero-padded from the true head dim D to :func:`kernel_head_dim`,
    and cut the results back: ``fn`` returns a tensor or a tuple whose
    (B, H, L, D_padded) members are cut to D; others (the log-sum-exp) pass
    as they are. The padded columns of q and k add nothing to a score, and
    those of v, out and g nothing to a kept column, so the result is the
    unpadded call's."""
    d = q.shape[-1]
    dp = kernel_head_dim(d)
    scale = 1.0 / math.sqrt(d)
    tensors = (q, k, v, *like_q)
    if dp != d:
        tensors = tuple(F.pad(t, (0, dp - d)) for t in tensors)
        heads = {t.shape for t in tensors}
    result = fn(*tensors, scale=scale)
    if dp == d:
        return result

    def cut(t):
        return t[..., :d] if t is not None and t.dim() == 4 and t.shape in heads else t

    return tuple(cut(t) for t in result) if isinstance(result, tuple) else cut(result)


def whole_kv_smem_bytes(lk: int, head_dim: int, dtype: torch.dtype) -> int:
    """Shared memory K1 takes for one block.

    bf16: K and V of one (batch*head) padded to whole 64-key tiles (the pad
    rows are zero-filled), and a float bias per key: at DETR's 920 keys and
    D 32, 2*960*32*2 + 960*4 = 126,720 B. float32: K and V, the 64-row query
    tile and one mask byte per key: 2*920*32*4 + 64*32*4 + 920 = 244,632 B;
    at head dim 128 no query tile (each thread loads its quarter of the row):
    2*197*128*4 + 197 = 201,925 B at ViT-H's 197 keys. Above 128 the panel
    body's, whatever Lk (:func:`wide_forward_plan`): float32 at D 256
    217,088 B, bf16 198,728 B.
    """
    if is_wide(head_dim):
        return wide_forward_plan(head_dim, dtype)["smem_bytes"]
    head_dim = kernel_head_dim(head_dim)
    if dtype == torch.bfloat16:
        keys = _ceil(lk, TILE_KEYS) * TILE_KEYS
        return 2 * keys * head_dim * 2 + 4 * keys
    item = torch.empty((), dtype=dtype).element_size()
    query_tile = 0 if head_dim > 64 else QUERY_TILE * head_dim * item
    return 2 * lk * head_dim * item + query_tile + lk


def whole_kv_fits(lk: int, head_dim: int, dtype: torch.dtype) -> bool:
    """Whether one (batch*head)'s K1 block fits in the 227 KB a block can use."""
    return whole_kv_smem_bytes(lk, head_dim, dtype) <= BLOCK_SMEM_BYTES


def whole_kv_plan(lq: int, lk: int, head_dim: int, dtype: torch.dtype) -> dict:
    """K1's launch: query-row blocks per (batch*head) and threads a block,
    which the wrapper passes to the kernel's entry point, and shared bytes a
    block.

    bf16: one warp per 16 query rows; the fewest blocks of at most 16 warps
    (8 at head dim 128, :func:`whole_kv_max_warps`), the warps spread evenly
    over them. Only one block fits on an SM at DETR's 920 keys (126,720 B),
    so a block takes as many rows as it can: 920 rows are 58 warp tiles, 4
    blocks of 15 warps (480 threads); 100 rows (the decoder) one block of 7
    warps. float32: 64-row blocks of 256 threads. Above head dim 128 the
    source sets the panel body's grid itself, which this reports: blocks of
    256 threads, 64 query rows (float32) or 128 (bf16), on each of the
    plan's column panels (grid z, :func:`wide_forward_plan`).
    """
    if is_wide(head_dim):
        wide = wide_forward_plan(head_dim, dtype)
        blocks, threads = _ceil(lq, wide["query_rows"]), 4 * QUERY_TILE
    elif dtype == torch.bfloat16:
        tiles = _ceil(lq, WARP_ROWS)
        blocks = _ceil(tiles, whole_kv_max_warps(head_dim))
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
    Above head dim 128 K1 is the panel body, whose shared memory does not
    depend on Lk, so it always fits: bf16 takes K2 (the in-line Hopper body
    at 192 and 256, the bf16 panel body above) and float32 K1 (the float32
    panel body), by the same rule.
    """
    return dtype == torch.bfloat16 or not whole_kv_fits(lk, head_dim, dtype)


def is_wgmma_forward(head_dim: int, dtype: torch.dtype, flash: bool = True) -> bool:
    """Whether a forward of ``head_dim`` runs a Hopper body (wgmma, TMA):
    bf16 K2 (``flash``) at every head dim above 32 (64 and 128 the
    producer-warp body, 192 and 256 the in-line one, above 256 the panel
    body), bf16 K1 above 128 (the panel body); K1 up to 128 and K2 at 16
    and 32 run ``mma.sync``, float32 the CUDA cores."""
    return dtype == torch.bfloat16 and kernel_head_dim(head_dim) > (32 if flash else HEAD_DIMS[-1])


def is_wgmma_pair(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the backward pair of a call of ``head_dim`` runs the Hopper
    bodies: bf16 at an instantiated head dim of 64, 128, 192 or 256 (33 to
    256: 48, 80, 100, 136, 200 ... padded to them); above 256 the chunked
    bodies."""
    return dtype == torch.bfloat16 and kernel_head_dim(head_dim) in WGMMA_HEAD_DIMS


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels. Raises when there is no card."""
    lib = build.load_library()
    # (dtype, q, k, v, mask, out, lse, B, H, Lq, Lk, D, scale[, blocks, threads], stream)
    head = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float]
    lib.attention_whole_kv.argtypes = head + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.attention_flash.argtypes = head + [ctypes.c_void_p]
    # (dtype, q, k, v, mask, out, lse, g, dq, dk, dv, scratch, B, H, Lq, Lk, D, scale, stream)
    lib.attention_backward.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                                       + [ctypes.c_float, ctypes.c_void_p])
    # (dtype, Lq, D): the query rows of the backward's scratch a (batch*head)
    lib.attention_backward_scratch_rows.argtypes = [ctypes.c_int] * 3
    lib.attention_backward_scratch_rows.restype = ctypes.c_int
    # (dtype, D, &panels, &cols, &acc, &smem): the panel bodies' plan
    lib.attention_forward_plan.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 4
    lib.attention_forward_plan.restype = ctypes.c_int
    for name in launch_counts:
        getattr(lib, name).restype = ctypes.c_int
    fn = lib.attention_kernel_attributes
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)] + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    return lib


def library_forward_plan(head_dim: int, dtype: torch.dtype) -> dict:
    """The library's own panel plan at ``head_dim`` (padded) and ``dtype``
    (``attention_forward_plan``), with :func:`wide_forward_plan`'s keys, to
    hold that mirror against the source on the card."""
    d = kernel_head_dim(head_dim)
    vals = [ctypes.c_int() for _ in range(4)]
    err = load_library().attention_forward_plan(_DTYPE_CODES[dtype], d, *map(ctypes.byref, vals))
    if err != 0:
        raise ValueError(f"the library has no panel plan at head dim {d} in {dtype} (error {err})")
    panels, cols, acc, smem = (x.value for x in vals)
    return {"panels": panels, "panel_cols": cols, "acc_cols": acc, "smem_bytes": smem,
            "widths": [cols] * (panels - 1) + [d - (panels - 1) * cols]}


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
    if D != kernel_head_dim(D):
        raise ValueError(f"head dim {D} is not one the kernels are built for; padded_call pads it to "
                         f"{kernel_head_dim(D)}")
    if Lq == 0 or k.shape[2] == 0:
        raise ValueError("empty query or key sequence")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("q, k, v must be contiguous and 16-byte aligned")
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != (B, k.shape[2]):
            raise ValueError(f"key_padding_mask must be bool (B, Lk), got {mask.dtype} {tuple(mask.shape)}")
        if mask.device != q.device or not mask.is_contiguous():
            raise ValueError("key_padding_mask must be contiguous on q's device")


def _launch(name: str, q, k, v, mask, with_lse: bool, scale: float, *grid: int):
    _check(q, k, v, mask)
    build.refuse_autograd(name, q, k, v)
    lib = load_library()
    B, H, Lq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Lq, dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H, Lq, k.shape[2], D, scale, *grid, stream,
        )
    build.check_launch(lib, name, err)
    _count(name, D)
    return (out, lse) if with_lse else out


def _plain(q, k, v, mask, with_lse: bool):
    out = attention_reference(q, k, v, mask)
    return (out, attention_lse(q, k, mask)) if with_lse else out


def attention_whole_kv(q, k, v, key_padding_mask=None, *, with_lse: bool = False):
    """K1: q (B,H,Lq,D), k/v (B,H,Lk,D), mask (B,Lk) bool True = valid.

    ``with_lse``: also return each query row's float32 log-sum-exp (B,H,Lq),
    for the backward; in float32, and in bf16 above head dim 128 (the panel
    body; bf16 calls take K2 on the model paths)."""
    if q.device.type == "cpu":
        return _plain(q, k, v, key_padding_mask, with_lse)
    if not whole_kv_fits(k.shape[2], q.shape[3], q.dtype):
        raise ValueError(
            f"K/V of {k.shape[2]} keys x {q.shape[3]} in {q.dtype} exceed a block's "
            "shared memory; use attention_flash"
        )
    if with_lse and q.dtype == torch.bfloat16 and not is_wide(q.shape[3]):
        raise ValueError("K1's bf16 body writes no log-sum-exp; use_flash sends bf16 calls to K2")
    plan = whole_kv_plan(q.shape[2], k.shape[2], q.shape[3], q.dtype)
    return padded_call(lambda q, k, v, scale: _launch("attention_whole_kv", q, k, v, key_padding_mask, with_lse,
                                                      scale, plan["blocks_per_head"], plan["threads"]),
                       q, k, v)


def attention_flash(q, k, v, key_padding_mask=None, *, with_lse: bool = False):
    """K2: same contract as :func:`attention_whole_kv`, any Lk, ``with_lse``
    in both types."""
    if q.device.type == "cpu":
        return _plain(q, k, v, key_padding_mask, with_lse)
    return padded_call(lambda q, k, v, scale: _launch("attention_flash", q, k, v, key_padding_mask, with_lse, scale),
                       q, k, v)


def attention_backward(q, k, v, key_padding_mask, out, lse, g):
    """B.4's backward on the card: (dq, dk, dv) of ``attention_reference`` at
    (q, k, v) for the output gradient g, from the forward's ``out`` and
    ``lse`` (``with_lse=True``). Two launches, counted as one: the dQ kernel
    (which also writes D = rowsum(g * out) and the log-sum-exp in base 2 to a
    float32 scratch), then the dK/dV kernel. Deterministic: no atomics.
    Raises on a CPU tensor (its plain version is
    ``ops.attention.attention_backward_reference``)."""
    return padded_call(lambda q, k, v, out, g, scale: _backward(q, k, v, key_padding_mask, out, lse, g, scale),
                       q, k, v, out, g)


def _backward(q, k, v, key_padding_mask, out, lse, g, scale: float):
    _check(q, k, v, key_padding_mask)
    B, H, Lq, D = q.shape
    for name, t in (("out", out), ("g", g)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q {tuple(q.shape)} {q.dtype}, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if lse.shape != (B, H, Lq) or lse.dtype != torch.float32 or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be float32 (B,H,Lq) = {(B, H, Lq)} on q's device, got {lse.dtype} {tuple(lse.shape)}")
    lib = load_library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # lse in base 2 and D for each query row, Lq padded to the dQ kernel's
    # row blocks as the library pads it (the dK/dV kernel copies whole
    # tiles); the dQ kernel fills it.
    rows = lib.attention_backward_scratch_rows(_DTYPE_CODES[q.dtype], Lq, D)
    scratch = torch.empty(2, B * H, rows, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_backward(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_padding_mask is None else key_padding_mask.data_ptr(), out.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
            B, H, Lq, k.shape[2], D, scale, stream,
        )
    build.check_launch(lib, "attention_backward", err)
    _count("attention_backward", D)
    return dq, dk, dv
