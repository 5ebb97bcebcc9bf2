"""Wrappers of the hand-written CUDA attention kernels (``csrc/attention.cu``).

Counterparts of the Pallas kernels in
``office_person_detection_vit_tpu/ops/attention.py``:

- :func:`attention_whole_kv` replaces ``attention_pallas`` /
  ``_fused_attn_kernel`` (K1): the head's whole K and V in shared memory, an
  exact two-pass softmax;
- :func:`attention_flash` replaces ``attention_pallas_flash`` /
  ``_flash_attn_kernel`` (K2): K/V streamed in tiles with an online
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
:func:`panel_forward_plan`); the float32 pair the register-tiled pair
(``attention_bwd_*_fma``, :func:`pair_backward_plan`) and the bf16 pair
above 256 the ``wgmma`` pair on column panels (``attention_bwd_*_wgmma_panels``:
the score operands streamed in 64-column chunks, dQ on the forward's column
panels, dK/dV on 128-column blocks), which take any such multiple.

In bf16 the forwards and the backward pair run their products on the tensor
cores: K1 up to head dim 128 on ``mma.sync`` m16n8k16 (one warp per 16
query rows; :func:`whole_kv_plan` gives K1's grid); K2 and the pair at every
head dim and K1 above 128 on Hopper's ``wgmma`` with TMA loads
(:func:`is_wgmma_forward`, :func:`is_wgmma_pair`; warpgroups of 64 rows, two
a block, and at head dims 16 and 32 one a block over short sequences; the
library sizes the pair's scratch). In float32, K2 up to head
dim 128 and the backward pair up to 128 run on the tensor cores as three
TF32 products a float32 product (``attention_flash_tf32`` and
``attention_bwd_{dq,dkdv}_tf32``, 3xTF32, :func:`is_tf32_forward`,
:func:`is_tf32_pair`: ``mma.sync`` m16n8k8, float32's accuracy); the rest on
the CUDA cores: K1 at head dims 16 and 32 on four threads per row in 64-row
blocks; K1 at 64 and 128 (three and two blocks an SM), every forward above
128 and the pair above 128 on the register-tiled bodies' 16 x 16 threads,
each a 4 x 4 block of scores. No path calls float32 K1 up to 128
(:func:`use_flash`).

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
#: source): the panel bodies and the bf16 pair stream Q and K in chunks of
#: it above 256.
WIDE_CHUNK = 64
#: Most output columns a panel body's block accumulates (kPanelMax); wider
#: heads are cut into column panels on grid z.
PANEL_MAX = 256
#: The float32 pair's dK/dV kernel: output columns a block (the source's
#: kPairOut), on ceil(D / 128) blocks of grid z.
PAIR_DKDV_COLS = 128
#: An SM's shared memory, and what each resident block reserves of it.
SM_SMEM_BYTES, BLOCK_RESERVED_SMEM = 233_472, 1024
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
    192 and 256 runs a panel body (:func:`panel_forward_plan`), the float32
    pair the register-tiled pair and the bf16 pair above 256 the ``wgmma``
    pair on column panels."""
    return kernel_head_dim(head_dim) > HEAD_DIMS[-1]


def blocks_an_sm(smem_bytes: int) -> int:
    """Blocks of 256 threads that an SM's shared memory holds at
    ``smem_bytes`` a block (at most 8: 2,048 threads an SM)."""
    return min(8, SM_SMEM_BYTES // (smem_bytes + BLOCK_RESERVED_SMEM))


def _panel_cols(d: int) -> tuple[int, int, list]:
    """``panel_plan`` of the source: (panels, panel_cols, widths)."""
    panels = _ceil(d, PANEL_MAX)
    cols = _ceil(_ceil(d, panels), 16) * 16
    return panels, cols, [cols] * (panels - 1) + [d - (panels - 1) * cols]


def panel_forward_plan(head_dim: int, dtype: torch.dtype) -> dict:
    """The panel bodies' launch (``panel_plan`` and ``panel_smem_bytes`` in
    the source, which ``attention_forward_plan`` exports): every forward
    above head dim 128 but bf16 K2 at 192 and 256, and float32 K1 at 64 and
    128 (33-128 padded to them). A block accumulates at most
    :data:`PANEL_MAX` output columns, so the padded head dim D is cut into
    ``panels`` = ceil(D / 256) column panels on grid z of ``panel_cols`` =
    ceil(D / panels / 16) * 16 columns each (``widths``: the last takes the
    rest), a block accumulating ``acc_cols`` = ceil(panel_cols / 64) * 64
    of them. Q stays in shared memory (``q_resident``) when there is one
    panel (D <= 256), but for float32 at 128 columns, and streams through
    the ring in 64-column chunks beside K otherwise, so ``smem_bytes`` does
    not grow with D beyond 256's, nor with Lk. ``min_blocks``: the blocks
    an SM the body's launch bounds ask for (float32: 3 at 64 accumulated
    columns, 2 at 128, else 1; bf16 1).

    bf16 (128 query rows a block): Q, 128 rows x D x 2 B, when it stays; 4
    ring slots of acc_cols / 64 x 8 KB; a 64-float key bias a slot; 9
    mbarriers; 1 KB for the 1024-byte alignment. float32 (64 rows): Q, 64
    rows of D + 4 floats, when it stays; 2 slots of 64 rows of acc_cols + 4
    floats (at least 2 x 68 when Q streams: a Q and a K chunk); the tile's
    p, 64 x 68 floats. K1 at 64: 4 x 64 x 68 floats, 69,632 B; at 128 (Q
    streamed): (2 x 64 x 136 + 64 x 68) floats, 87,040 B.
    """
    d = kernel_head_dim(head_dim)
    f32_k1 = dtype == torch.float32 and d in (64, 128)
    if d <= HEAD_DIMS[-1] and not f32_k1:
        raise ValueError(f"head dim {head_dim} in {dtype} runs no panel body (those take head dims above 128, "
                         "and float32 K1 at 64 and 128)")
    panels, cols, widths = _panel_cols(d)
    if widths[-1] <= 0:
        raise ValueError(f"head dim {head_dim}: no panel plan")
    acc = _ceil(cols, WIDE_CHUNK) * WIDE_CHUNK
    if dtype == torch.bfloat16:
        resident = panels == 1
        np_ = acc // WIDE_CHUNK
        smem = ((np_ * PANEL_BF16_ROWS * 128 if resident else 0) + PANEL_BF16_STAGES * np_ * 64 * 128
                + PANEL_BF16_STAGES * 64 * 4 + 8 * (1 + 2 * PANEL_BF16_STAGES) + 1024)
        rows, min_blocks = PANEL_BF16_ROWS, 1
    else:
        resident = panels == 1 and acc != 128
        slot = acc + 4 if resident else max(acc + 4, 2 * 68)
        smem = ((QUERY_TILE * (d + 4) if resident else 0) + 2 * QUERY_TILE * slot + QUERY_TILE * 68) * 4
        rows, min_blocks = QUERY_TILE, {64: 3, 128: 2}.get(acc, 1)
    return {"head_dim": d, "panels": panels, "panel_cols": cols, "widths": widths, "acc_cols": acc,
            "query_rows": rows, "smem_bytes": smem, "q_resident": resident, "min_blocks": min_blocks}


def pair_backward_plan(head_dim: int) -> dict:
    """The float32 pair's launch above head dim 128 (``launch_backward_fma``
    in the source; ``attention_backward_plan`` exports it). The dQ kernel
    takes the forward's column panels (:func:`panel_forward_plan`'s
    ``panels``, ``panel_cols``, ``widths``, ``acc_cols``) on grid z, 64 query
    rows a block; the dK/dV kernel ``dkdv_blocks`` = ceil(D / 128) blocks of
    :data:`PAIR_DKDV_COLS` columns on grid z (``dkdv_widths``), 64 keys a
    block. Shared memory, independent of D and of both lengths: two ring
    slots of 64 rows of max(4 x 68, acc + 4) floats (four 64-column chunks
    of the score operands, or an item of output columns), and 64 x 68 floats
    of dS (dQ) or of P^T and dS^T (dK/dV): 156,672 and 174,080 B."""
    d = kernel_head_dim(head_dim)
    if d <= HEAD_DIMS[-1]:
        raise ValueError(f"head dim {head_dim}: the register-tiled pair takes head dims above 128")
    panels, cols, widths = _panel_cols(d)
    acc = _ceil(cols, WIDE_CHUNK) * WIDE_CHUNK
    blocks = _ceil(d, PAIR_DKDV_COLS)

    def slot(n):
        return QUERY_TILE * max(4 * 68, n + 4)

    return {"head_dim": d, "dq_panels": panels, "dq_cols": cols, "dq_widths": widths, "dq_acc": acc,
            "dq_smem_bytes": (2 * slot(acc) + QUERY_TILE * 68) * 4, "dkdv_blocks": blocks,
            "dkdv_cols": PAIR_DKDV_COLS,
            "dkdv_widths": [PAIR_DKDV_COLS] * (blocks - 1) + [d - (blocks - 1) * PAIR_DKDV_COLS],
            "dkdv_smem_bytes": (2 * slot(PAIR_DKDV_COLS) + 2 * QUERY_TILE * 68) * 4}


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

    bf16 up to head dim 128: K and V of one (batch*head) padded to whole
    64-key tiles (the pad rows are zero-filled), and a float bias per key: at
    DETR's 920 keys and D 32, 2*960*32*2 + 960*4 = 126,720 B. float32 at
    head dims 16 and 32: K and V, the 64-row query tile and one mask byte per
    key: 2*920*32*4 + 64*32*4 + 920 = 244,632 B. float32 at 64 and 128 and
    both types above 128: the panel body's, whatever Lk
    (:func:`panel_forward_plan`): float32 69,632 B at 64, 87,040 B at 128,
    217,088 B at 256; bf16 198,728 B at 256.
    """
    d = kernel_head_dim(head_dim)
    if is_wide(d) or (dtype == torch.float32 and d >= 64):
        return panel_forward_plan(d, dtype)["smem_bytes"]
    if dtype == torch.bfloat16:
        keys = _ceil(lk, TILE_KEYS) * TILE_KEYS
        return 2 * keys * d * 2 + 4 * keys
    return 2 * lk * d * 4 + QUERY_TILE * d * 4 + lk


def whole_kv_fits(lk: int, head_dim: int, dtype: torch.dtype) -> bool:
    """Whether one (batch*head)'s K1 block fits in the 227 KB a block can
    use: the bodies that stage the head's whole K and V (bf16 up to 128,
    float32 at 16 and 32) up to a number of keys; the panel bodies at any."""
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
    warps. float32: 64-row blocks of 256 threads (at 64 and 128 the panel
    body's, which the source launches on the panel grid, checking this
    plan). Above head dim 128 the source sets the panel body's grid itself,
    which this reports: blocks of 256 threads, 64 query rows (float32) or
    128 (bf16), on each of the plan's column panels (grid z,
    :func:`panel_forward_plan`).
    """
    if is_wide(head_dim):
        wide = panel_forward_plan(head_dim, dtype)
        blocks, threads = _ceil(lq, wide["query_rows"]), 4 * QUERY_TILE
    elif dtype == torch.bfloat16:
        tiles = _ceil(lq, WARP_ROWS)
        blocks = _ceil(tiles, whole_kv_max_warps(head_dim))
        threads = 32 * _ceil(tiles, blocks)
    else:
        blocks, threads = _ceil(lq, QUERY_TILE), 4 * QUERY_TILE
    return {"blocks_per_head": blocks, "threads": threads,
            "smem_bytes": whole_kv_smem_bytes(lk, head_dim, dtype)}


def use_flash(head_dim: int, dtype: torch.dtype) -> bool:
    """The whole-KV/flash switch, set by H100 measurements: by the padded
    head dim and the type alone (the key count does not enter).

    bf16: always K2 (flash). Timed beside each other
    (``attention_kernel_bench``, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
    §6), K2 (the narrow Hopper body) is faster at all three of DETR-R50's
    shapes (B 8, H 8, D 32): encoder 920x920 0.0372 against K1's 0.0678 ms,
    cross-attention 100x920 0.0126 against 0.0223, decoder self-attention
    100x100 0.0040 against 0.0058. K1 pays a second
    exponential per score (it normalizes before rounding, as
    _fused_attn_kernel does) and, with a whole head's K/V in shared memory,
    runs one block an SM.
    float32 up to head dim 128 (every head dim padded to 16, 32, 64 or 128):
    always K2 (its 3xTF32 body). Timed beside each other (K1, K2, K2, K1 on
    one input) at 50, 84, 197, 421, 920 and 3681 keys (Lq = Lk; B 8 and H 8
    up to 920, B 1 at 3681) and every head dim (``attention_kernel_bench
    --ladder``, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6), K2 is
    faster at every length where K1's block fits: at 50 keys
    0.0038 / 0.0045 / 0.0063 / 0.0109 ms against K1's 0.0094 / 0.0134 /
    0.0085 / 0.0126 at head dims 16 / 32 / 64 / 128, at 197 keys 0.0103 /
    0.0147 / 0.0246 / 0.0437 against 0.0323 / 0.0501 / 0.0496 / 0.0884, at
    3681 0.5990 / 1.2638 against 1.6211 / 3.0946 at 64 / 128, at CLIP's
    (64, 12, 50, 50, 64) 0.0237 against 0.0321 and at DETR-small's
    encoder (1, 8, 84, 84, 16) 0.0049 against 0.0133.
    Head dims 16 and 32 once kept K1 where its block fits, for two
    card-against-CPU checks of ``chip_smoke.py`` that sat on near ties
    ([11b]'s tracker, [14a]'s float32 gradients); those checks now hold the
    card's continuous outputs to their bars and take the discrete branches
    from one side (``check_conditioning``), so nothing keeps K1 there.
    Above head dim 128 both types run panel bodies: bf16 takes K2 (the
    in-line Hopper body at 192 and 256, the bf16 panel body above) and
    float32 K1 (the float32 panel body), which fits at any Lk. No path
    calls float32 K1 up to 128 (its bodies stay for the bench, ROADMAP
    B.S5).
    (The JAX package's 8 MB ``_FLASH_BYTES_THRESHOLD`` is a TPU VMEM figure
    and does not apply.)
    """
    return dtype == torch.bfloat16 or not is_wide(head_dim)


def is_wgmma_forward(head_dim: int, dtype: torch.dtype, flash: bool = True) -> bool:
    """Whether a forward of ``head_dim`` runs a Hopper body (wgmma, TMA):
    bf16 K2 (``flash``) at every head dim (16 and 32 the narrow body
    ``attention_flash_wgmma_narrow``, 64 and 128 the producer-warp body, 192
    and 256 the in-line one, above 256 the panel body), bf16 K1 above 128
    (the panel body); bf16 K1 up to 128 runs ``mma.sync``; float32 K2 up to
    128 runs ``mma.sync`` in 3xTF32 (:func:`is_tf32_forward`), every other
    float32 forward the CUDA cores."""
    return dtype == torch.bfloat16 and (flash or kernel_head_dim(head_dim) > HEAD_DIMS[-1])


def is_wgmma_pair(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the backward pair of a call of ``head_dim`` runs the Hopper
    bodies: bf16 at every head dim (16 and 32 on
    ``attention_bwd_*_wgmma_narrow``, 64, 128, 192 and 256 and those padded
    to them on ``attention_bwd_*_wgmma*``, above 256 on the column panels of
    ``attention_bwd_*_wgmma_panels``); float32 up to 128 runs ``mma.sync``
    in 3xTF32 (:func:`is_tf32_pair`) and above 128 the CUDA cores."""
    return dtype == torch.bfloat16


def is_tf32_forward(head_dim: int, dtype: torch.dtype, flash: bool = True) -> bool:
    """Whether a forward of ``head_dim`` runs the 3xTF32 body
    (``attention_flash_tf32``: three TF32 products a float32 product on the
    tensor cores): float32 K2 up to head dim 128."""
    return dtype == torch.float32 and flash and not is_wide(head_dim)


def is_tf32_pair(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the backward pair of a call of ``head_dim`` runs the 3xTF32
    bodies (``attention_bwd_dq_tf32`` + ``attention_bwd_dkdv_tf32``: three
    TF32 products a float32 product on the tensor cores): float32 up to
    head dim 128."""
    return dtype == torch.float32 and not is_wide(head_dim)


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
    # (D, 7 x &int): the float32 pair's plan above 128
    lib.attention_backward_plan.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 7
    lib.attention_backward_plan.restype = ctypes.c_int
    for name in launch_counts:
        getattr(lib, name).restype = ctypes.c_int
    fn = lib.attention_kernel_attributes
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)] + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    return lib


def library_forward_plan(head_dim: int, dtype: torch.dtype) -> dict:
    """The library's own panel plan at ``head_dim`` (padded) and ``dtype``
    (``attention_forward_plan``), with :func:`panel_forward_plan`'s keys, to
    hold that mirror against the source on the card."""
    d = kernel_head_dim(head_dim)
    vals = [ctypes.c_int() for _ in range(4)]
    err = load_library().attention_forward_plan(_DTYPE_CODES[dtype], d, *map(ctypes.byref, vals))
    if err != 0:
        raise ValueError(f"the library has no panel plan at head dim {d} in {dtype} (error {err})")
    panels, cols, acc, smem = (x.value for x in vals)
    return {"panels": panels, "panel_cols": cols, "acc_cols": acc, "smem_bytes": smem,
            "widths": [cols] * (panels - 1) + [d - (panels - 1) * cols]}


def library_backward_plan(head_dim: int) -> dict:
    """The library's own plan of the float32 pair at ``head_dim`` (padded;
    ``attention_backward_plan``), with :func:`pair_backward_plan`'s keys."""
    d = kernel_head_dim(head_dim)
    vals = [ctypes.c_int() for _ in range(7)]
    err = load_library().attention_backward_plan(d, *map(ctypes.byref, vals))
    if err != 0:
        raise ValueError(f"the library has no float32 pair plan at head dim {d} (error {err})")
    panels, cols, acc, dq_smem, blocks, out_cols, dkdv_smem = (x.value for x in vals)
    return {"dq_panels": panels, "dq_cols": cols, "dq_acc": acc, "dq_smem_bytes": dq_smem,
            "dq_widths": [cols] * (panels - 1) + [d - (panels - 1) * cols], "dkdv_blocks": blocks,
            "dkdv_cols": out_cols, "dkdv_smem_bytes": dkdv_smem,
            "dkdv_widths": [out_cols] * (blocks - 1) + [d - (blocks - 1) * out_cols]}


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
    Any Lk in float32 at head dims above 32 and in bf16 above 128 (the panel
    bodies); elsewhere what fits a block (:func:`whole_kv_fits`).

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
