"""Wrapper of the hand-written CUDA fused bottleneck (``csrc/bottleneck.cu``).

Counterpart of ``fused_bottleneck`` / ``_kernel`` (K3) in
``office_person_detection_vit_tpu/ops/fused_bottleneck.py``. A block owns
``tile_h`` x ``tile_w`` output pixels and keeps y1 on its haloed ring and y2
in shared memory. bf16 runs its products on the tensor cores
(``bottleneck_mma``), float32 on the CUDA cores (``bottleneck_kernel``).
:func:`plan` is the one owner of the launch geometry: it picks ``tile_w``
and the tiles from the shared-memory budget, and the C entry point refuses a
geometry its tiles do not cover. The source is built with the port's other
CUDA sources at first use (``kernels/build.py``).

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

#: float32: rows of the kernel's GEMM tile (instantiations of the source),
#: largest first; the tile has 4096 outputs, so its width is 4096 / rows.
GEMM_ROWS = (64, 32, 16)
#: float32: K chunk staged through shared memory per step (kKC in the source).
K_CHUNK = 32
#: bf16: the ring rows a block's tiles cover (the C entry's ``rows``) ->
#: (m16 tiles a warp holds, n8 tiles a warp holds, blocks an SM). 8 warps, 2
#: along the rows and 4 along the columns, so a pass covers 32 x n8 tiles
#: columns: 64 in the 160-row tiles, whose registers allow two blocks an SM,
#: and 128 in the 128-row tiles.
MMA_TILES = {160: (5, 2, 2), 128: (4, 4, 1)}
MMA_WARPS_N = 4
#: The plan's price of one weight value read from L2, in tensor-core
#: multiply-adds. An empirical constant: at DETR-R50's four stages every
#: price from 11 to 68 picks the same patches (a CPU test holds this), and
#: those patches were the fastest of the widths that
#: ``bottleneck_phase_profile`` times beside them on an H100 (PERF.md); 27
#: lies inside that range.
WEIGHT_READ_MACS = 27
#: Shared memory of a block when two share an SM (228 KB an SM, 1 KB of it
#: reserved for each block).
TWO_BLOCK_SMEM_BYTES = (233_472 - 2 * 1024) // 2
#: bf16: K chunk (kChunk), cp.async stages (kStages), channel padding of the
#: y1 and y2 rows (kChanAlign) in the source.
MMA_K_CHUNK, MMA_STAGES, MMA_CHAN_ALIGN = 64, 3, 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(rows: int, tile_h: int, tile_w: int, mid: int, dtype: torch.dtype) -> int:
    """Shared memory of one block.

    float32: the A and weight chunks (float), y1 on the (tile_h+2) x
    (tile_w+2) ring and y2 on the patch. bf16 (``mma_layout`` in the source):
    y1 on the ring, then y2 or the reduce's x staging (they share bytes),
    then the weight staging and the stages' mbarriers, and 1024 bytes to
    align the base for the TMA's swizzle; ring and patch rows padded to 16,
    channels to 64. The source's ``bottleneck_smem_bytes`` gives what a
    launch requests; a card test holds the two together.
    """
    ring = (tile_h + 2) * (tile_w + 2)
    if dtype == torch.bfloat16:
        bn = 8 * MMA_WARPS_N * MMA_TILES[rows][1]
        rp, pp, mp = _round_up(ring, 16), _round_up(tile_h * tile_w, 16), _round_up(mid, MMA_CHAN_ALIGN)
        x_staging = MMA_STAGES * rp * MMA_K_CHUNK * 2
        barriers_and_alignment = 64 + 1024
        return rp * mp * 2 + max(pp * mp * 2, x_staging) + MMA_STAGES * MMA_K_CHUNK * bn * 2 + barriers_and_alignment
    item = torch.empty((), dtype=dtype).element_size()
    return K_CHUNK * (rows + 4) * 4 + K_CHUNK * (4096 // rows) * 4 + (ring + tile_h * tile_w) * mid * item


def _plan_mma(width: int, mid: int, tile_h: int, channels: int) -> tuple[int, int, int]:
    """bf16: of the patch widths whose haloed ring the tiles cover and whose
    block fits (two blocks an SM for the 160-row tiles), the cheapest over a
    row of patches. A patch costs its multiply-adds with the rows padded to
    16 (ring rows x C x M for the reduce, patch rows x (9 M + C) x M for the
    3x3 and the expand) plus :data:`WEIGHT_READ_MACS` for each weight value
    it reads from L2 (2 C M + 9 M^2). Patches are split evenly over the
    width; a tie goes to fewer patches. The 160-row tiles (64-column
    passes, two blocks an SM) come first at M 64, whose one pass they fill;
    from M 128 on the 128-row tiles (128-column passes, half the re-reads
    of x in the reduce; 1 x 40 at M 512 is a ring of 126 rows), which
    measured faster at DETR-R50's stage 2 too (PERF.md)."""
    order = (128, 160) if _round_up(mid, MMA_CHAN_ALIGN) >= 128 else (160, 128)
    for rows in order:
        budget = TWO_BLOCK_SMEM_BYTES if MMA_TILES[rows][2] == 2 else BLOCK_SMEM_BYTES
        best = None
        for widest in range(1, min(width, rows // (tile_h + 2) - 2) + 1):
            patches = -(-width // widest)
            tile_w = -(-width // patches)  # as many patches, evenly wide
            smem = smem_bytes(rows, tile_h, tile_w, mid, torch.bfloat16)
            if smem > budget:
                continue
            ring, patch = _round_up((tile_h + 2) * (tile_w + 2), 16), _round_up(tile_h * tile_w, 16)
            macs = ring * channels + patch * (9 * mid + channels) + WEIGHT_READ_MACS * (2 * channels + 9 * mid)
            cost = (patches * macs, patches)  # both / M
            if best is None or cost < best[0]:
                best = (cost, tile_w, smem)
        if best is not None:
            return rows, best[1], best[2]
    raise ValueError(f"no tile of tile_h={tile_h}, M={mid} in {torch.bfloat16} fits a block's shared memory")


def plan(width: int, mid: int, tile_h: int, dtype: torch.dtype, channels: int) -> tuple[int, int, int]:
    """(rows, tile_w, shared bytes) of a launch; ``rows`` selects the tiles.

    bf16 (tensor cores): :func:`_plan_mma`, with C = ``channels``. DETR-R50
    at 736x1280 (batch 8):
    stage 1 (W 320, M 64, tile_h 8) 160 rows, 8 x 14 pixels; stage 2 (W 160,
    M 128, tile_h 4) 128 rows, 4 x 16; stage 3 (W 80, M 256, tile_h 2) 128
    rows, 2 x 27; stage 4 (W 40, M 512, tile_h 1) 128 rows, 1 x 40
    (:func:`plan_report` gives blocks, weight traffic and shared bytes).

    float32 (CUDA cores): a patch is tile_h x (rows // tile_h) pixels, at
    most the image width. The first GEMM tile, largest first, whose block
    fits in half an SM's shared memory wins (two blocks per SM); else the
    first that fits in a block's 227 KB; ``channels`` does not enter it.
    """
    if dtype == torch.bfloat16:
        return _plan_mma(width, mid, tile_h, channels)
    for budget in (BLOCK_SMEM_BYTES // 2, BLOCK_SMEM_BYTES):
        for rows in GEMM_ROWS:
            if tile_h > rows:
                continue
            tile_w = min(rows // tile_h, width)
            smem = smem_bytes(rows, tile_h, tile_w, mid, dtype)
            if smem <= budget:
                return rows, tile_w, smem
    raise ValueError(f"no tile of tile_h={tile_h}, M={mid} in {dtype} fits a block's shared memory")


def plan_report(B: int, H: int, W: int, C: int, M: int, tile_h: int, dtype: torch.dtype) -> dict:
    """What :func:`plan` gives at one geometry: the tiles, pixels a block,
    blocks, the weight bytes all blocks read from L2 (each block reads W1,
    W2 and W3 once), the recompute factor of the 1x1 reduce (ring positions
    over patch pixels) and shared bytes a block."""
    rows, tile_w, smem = plan(W, M, tile_h, dtype, C)
    item = torch.empty((), dtype=dtype).element_size()
    blocks = B * (H // tile_h) * -(-W // tile_w)
    return {"tile_h": tile_h, "tile_w": tile_w, "rows": rows, "pixels": tile_h * tile_w, "blocks": blocks,
            "weight_l2_bytes": blocks * (2 * C * M + 9 * M * M) * item,
            "recompute": (tile_h + 2) * (tile_w + 2) / (tile_h * tile_w), "smem_bytes": smem}


def describe_plan(r: dict) -> str:
    """One line of a :func:`plan_report`."""
    return (f"{r['tile_h']} x {r['tile_w']} pixels a block ({r['pixels']}), {r['rows']} rows, {r['blocks']} blocks, "
            f"{r['weight_l2_bytes'] / 1e9:.3f} GB of weights from L2, y1 recompute {r['recompute']:.2f}x, "
            f"{r['smem_bytes']:,} B shared")


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels. Raises when there is no card."""
    lib = build.load_library()
    lib.fused_bottleneck.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.fused_bottleneck.restype = ctypes.c_int
    lib.bottleneck_kernel_attributes.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)] + [
        ctypes.POINTER(ctypes.c_int)] * 4
    lib.bottleneck_kernel_attributes.restype = ctypes.c_int
    lib.bottleneck_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.bottleneck_smem_bytes.restype = ctypes.c_longlong
    return lib


def kernel_attributes() -> list[dict]:
    """Registers, spill (local) bytes, static shared bytes and most threads
    of every K3 instantiation (``cudaFuncGetAttributes``)."""
    lib = load_library()
    out, i = [], 0
    while True:
        name = ctypes.c_char_p()
        vals = [ctypes.c_int() for _ in range(4)]
        if lib.bottleneck_kernel_attributes(i, ctypes.byref(name), *map(ctypes.byref, vals)) != 0:
            return out
        out.append(dict(zip(("regs", "local_bytes", "static_smem", "max_threads"), (v.value for v in vals)),
                        name=name.value.decode()))
        i += 1


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
    rows, tile_w, _ = plan(x.shape[2], w1.shape[1], tile_h, x.dtype, x.shape[3])
    return _launch(x, w1, b1, w2, b2, w3, b3, tile_h, tile_w, rows)


def _launch(x, w1, b1, w2, b2, w3, b3, tile_h: int, tile_w: int, rows: int) -> torch.Tensor:
    """K3 on checked CUDA tensors with the tiles it is given (the C entry
    point refuses a geometry they do not cover); :func:`plan` chooses them."""
    build.refuse_autograd("fused_bottleneck", x, w1, b1, w2, b2, w3, b3)
    lib = load_library()
    B, H, W, C = x.shape
    M = w1.shape[1]
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
