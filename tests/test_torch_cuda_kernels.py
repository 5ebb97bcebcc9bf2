"""The CUDA kernels (attention K1/K2, fused bottleneck K3) against their plain
version, on the card.

Marked ``cuda``; each test skips where there is no CUDA device (the CUDA
kernels have no CPU mode). On a GPU machine:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -m cuda -q

Attention tolerance: float32 1e-5 (summation order); bf16 1e-2 against the
plain version in float32 on the same values (probabilities and output rounded
to bf16), relative to max(1, |ref|) at the tile-edge lengths (see there). K3, relative to max(1, |ref|) against the plain version on the same
values: float32 1e-4 with TF32 off (summation order); bf16 2^-6, two ulps of
the output (its own rounding, and a y1 or y2 value next to a rounding
midpoint carried through the next product). The bf16 tiling's edge tests
hold it there against the plain version with float32 sums and with exact
sums (``bottleneck_kernel_bench.bf16_verdict``).
"""

import pytest
import torch

from office_person_detection_vit_torch import bottleneck_kernel_bench as bench
from office_person_detection_vit_torch.kernels import attention as kernels
from office_person_detection_vit_torch.kernels import bottleneck as k3
from office_person_detection_vit_torch.ops.attention import attention_reference, multi_head_attention
from office_person_detection_vit_torch.ops.fused_bottleneck import bottleneck_reference, fused_bottleneck

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
K3_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-6}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.load_library()


def _case(B, H, Lq, Lk, D, dtype, masked, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, D, generator=g).to("cuda", dtype) for L in (Lq, Lk, Lk))
    mask = None
    if masked:
        mask = torch.rand(B, Lk, generator=g) > 0.3
        mask[0] = False  # a fully-masked batch entry: mean(V)
        mask = mask.cuda()
    return q, k, v, mask


def _check_kernel(fn, q, k, v, mask, relative=False):
    before = kernels.launch_counts[fn.__name__]
    out = fn(q, k, v, mask)
    torch.cuda.synchronize()
    assert kernels.launch_counts[fn.__name__] == before + 1
    want = attention_reference(q.float(), k.float(), v.float(), mask)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    scale = want.abs().clamp(min=1.0) if relative else 1.0
    assert ((out.float() - want).abs() / scale).max().item() <= TOL[q.dtype]


# Lengths that cross the bf16 kernels' edges: 16-row warp tiles, 64-key
# tiles, K1's blocks of up to 16 warps (920 rows: 4 blocks of 15 warps) and
# the float32 kernels' 64-row blocks.
LQ, LK = (1, 67, 100, 920), (1, 15, 131, 920, 1000)


@pytest.mark.parametrize("fn", [kernels.attention_whole_kv, kernels.attention_flash])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", kernels.HEAD_DIMS)
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_plain(card, fn, dtype, D, masked):
    _check_kernel(fn, *_case(2, 3, 67, 131, D, dtype, masked))


@pytest.mark.parametrize("fn", [kernels.attention_whole_kv, kernels.attention_flash])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", kernels.HEAD_DIMS)
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_plain_at_tile_edges(card, fn, dtype, D, masked):
    """Every (Lq, Lk) pair of LQ x LK; with the mask, batch entry 0 has every
    key masked (mean(V)).

    bf16 is held relative to max(1, |ref|): with 15 keys an output reaches
    2.6, and the two roundings of the Pallas kernels (probabilities, then
    the output, each half an ulp, 2^-9 relative) give 1.19e-2 absolute there
    in an exact emulation of K1's rounding on the CPU, which the kernel
    matches. float32 stays absolute (summation order only).
    """
    for i, lq in enumerate(LQ):
        for j, lk in enumerate(LK):
            if fn is kernels.attention_whole_kv and not kernels.whole_kv_fits(lk, D, dtype):
                continue
            _check_kernel(fn, *_case(2, 3, lq, lk, D, dtype, masked, seed=10 * i + j),
                          relative=dtype == torch.bfloat16)


@pytest.mark.parametrize("fn", [kernels.attention_whole_kv, kernels.attention_flash])
@pytest.mark.parametrize(
    "shape", [(8, 8, 920, 920, 32), (8, 8, 100, 920, 32), (8, 8, 100, 100, 32)],
    ids=["encoder", "cross", "decoder_self"],
)
def test_kernel_matches_plain_at_the_main_path_shapes(card, fn, shape):
    """DETR-R50 at 736x1280, batch 8, bf16; ragged key padding, no entry all masked."""
    q, k, v, _ = _case(*shape, torch.bfloat16, False, seed=1)
    B, Lk = shape[0], shape[3]
    mask = torch.ones(B, Lk, dtype=torch.bool)
    for b in range(B):
        mask[b, Lk - ((b + 1) * Lk) // (4 * B):] = False
    _check_kernel(fn, q, k, v, mask.cuda())


def test_dispatch_takes_the_kernels(card):
    """multi_head_attention launches the kernel use_flash names: bf16 K2 at
    920 and at 100 keys; float32 K2 at 920 keys (K1 does not fit), K1 at 100."""
    q, k, v, mask = _case(1, 2, 50, 920, 32, torch.float32, True)
    short = [t[:, :, :100].contiguous() for t in (k, v)]
    before = dict(kernels.launch_counts)
    multi_head_attention(q, k, v, mask)
    multi_head_attention(q, *short, mask[:, :100].contiguous())
    multi_head_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask)
    multi_head_attention(q.bfloat16(), *(t.bfloat16() for t in short), mask[:, :100].contiguous())
    assert kernels.launch_counts["attention_flash"] == before["attention_flash"] + 3
    assert kernels.launch_counts["attention_whole_kv"] == before["attention_whole_kv"] + 1


@pytest.mark.parametrize(
    "dtype,blocks,threads",
    [(torch.bfloat16, 1, 192), (torch.bfloat16, 0, 224), (torch.bfloat16, 1, 544), (torch.bfloat16, 1, 200),
     (torch.float32, 1, 256), (torch.float32, 2, 128)],
    ids=["bf16_96_of_100_rows", "bf16_no_block", "bf16_17_warps", "bf16_part_warp", "f32_64_of_100_rows",
         "f32_not_256_threads"],
)
def test_whole_kv_refuses_a_grid_short_of_the_query_rows(card, dtype, blocks, threads):
    """K1's entry point takes its grid from whole_kv_plan and refuses one that
    leaves query rows without a warp, before it launches anything."""
    lib = kernels.load_library()
    q, k, v, _ = _case(1, 1, 100, 100, 32, dtype, False)
    out = torch.empty_like(q)
    plan = kernels.whole_kv_plan(100, 100, 32, dtype)
    assert (blocks, threads) != (plan["blocks_per_head"], plan["threads"])
    err = lib.attention_whole_kv(1 if dtype == torch.bfloat16 else 0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 None, out.data_ptr(), 1, 1, 100, 100, 32, blocks, threads,
                                 torch.cuda.current_stream().cuda_stream)
    assert err != 0
    _check_kernel(kernels.attention_whole_kv, q, k, v, None)  # the plan's grid still launches


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    q, k, v, _ = _case(1, 2, 8, 8, 32, torch.float32, False)
    with pytest.raises(ValueError):
        kernels.attention_flash(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        kernels.attention_flash(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        kernels.attention_whole_kv(*_case(1, 1, 8, 4000, 32, torch.float32, False)[:3])


def _bottleneck_case(B, H, W, C, M, dtype, b1=None, seed=0):
    x, ws = bench.make_inputs(B, H, W, C, M, dtype, "cuda", seed)
    if b1 is not None:
        ws[1].fill_(b1)  # relu(b1) != 0 would leak into the border rows and columns
    return x, list(ws)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,M,tile_h", [(256, 64, 4), (2048, 512, 1)], ids=["stage1", "stage4"])
@pytest.mark.parametrize("b1", [None, 3.0], ids=["random_b1", "border_b1_3"])
def test_bottleneck_matches_plain(card, dtype, C, M, tile_h, b1):
    """W = 20 leaves a ragged last patch of columns; every patch touches a border."""
    x, ws = _bottleneck_case(2, 8, 20, C, M, dtype, b1)
    before = k3.launch_counts["fused_bottleneck"]
    out = fused_bottleneck(x, *ws, tile_h=tile_h)
    torch.cuda.synchronize()
    assert k3.launch_counts["fused_bottleneck"] == before + 1
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = bottleneck_reference(x, *ws).float()
    assert out.dtype == dtype and out.shape == x.shape
    rel = ((out.float() - want).abs() / want.abs().clamp(min=1.0)).max().item()
    assert rel <= K3_TOL[dtype]


def test_bottleneck_wrapper_rejects_what_the_kernel_does_not_take(card):
    x, ws = _bottleneck_case(1, 4, 8, 64, 16, torch.float32)
    wide, _ = _bottleneck_case(1, 4, 16, 64, 16, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        k3.fused_bottleneck(wide[:, :, ::2], *ws, tile_h=4)
    half = [w.half() if w.dim() > 1 else w for w in ws]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k3.fused_bottleneck(x.half(), *half, tile_h=4)
    bad_w2 = torch.zeros(3, 3, 16, 24, device="cuda")
    with pytest.raises(ValueError, match="w2"):
        k3.fused_bottleneck(x, ws[0], ws[1], bad_w2, *ws[3:], tile_h=4)


def _check_bottleneck(x, ws, out):
    """bf16 K3 within K3's bar of the plain version with float32 sums and
    with exact sums."""
    torch.cuda.synchronize()
    assert out.dtype == x.dtype and out.shape == x.shape and bool(torch.isfinite(out).all())
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        plain32 = bottleneck_reference(x, *ws)
        exact = bottleneck_reference(x, *ws, accumulate=torch.float64)
    readings = (bench.errors(out, plain32)[1], bench.errors(out, exact)[1], bench.errors(plain32, exact)[1])
    assert bench.bf16_verdict(*readings, K3_TOL[x.dtype]) == "met", readings


@pytest.mark.parametrize(
    "W,tile_h,tile_w,rows",
    [(40, 4, 16, 160), (20, 4, 16, 160), (40, 8, 12, 160), (41, 2, 30, 128), (20, 1, 32, 128), (40, 1, 16, 128)],
    ids=["w40_p4x16", "w20_p4x16", "w40_p8x12", "w41_p2x30", "w20_p1x32", "w40_p1x16"],
)
@pytest.mark.parametrize("b1", [None, 3.0], ids=["random_b1", "border_b1_3"])
def test_bf16_bottleneck_ragged_patches(card, W, tile_h, tile_w, rows, b1):
    """The bf16 tiles at patch widths that do not divide W (the last patch of
    a row is ragged, or wider than the image), through the launch with the
    tiles given; b1 = 3 would leak relu(b1) into the border if SAME padding
    were not zero in y1."""
    x, ws = _bottleneck_case(2, 8, W, 256, 64, torch.bfloat16, b1)
    before = k3.launch_counts["fused_bottleneck"]
    out = k3._launch(x, *ws, tile_h, tile_w, rows)
    assert k3.launch_counts["fused_bottleneck"] == before + 1
    _check_bottleneck(x, ws, out)


@pytest.mark.parametrize("W", [40, 20])
@pytest.mark.parametrize("C,M,tile_h", [(256, 64, 8), (512, 128, 4), (1024, 256, 2), (2048, 512, 1)],
                         ids=["stage1", "stage2", "stage3", "stage4"])
def test_bf16_bottleneck_at_the_detr_channels(card, W, C, M, tile_h):
    """Each DETR-R50 (C, M) pair with its tile_h, at a small B*H*W, through
    the plan's tiles."""
    x, ws = _bottleneck_case(2, 8, W, C, M, torch.bfloat16, seed=C)
    _check_bottleneck(x, ws, fused_bottleneck(x, *ws, tile_h=tile_h))


@pytest.mark.parametrize("H,W,C,M,tile_h", [(23, 40, 2048, 512, 1), (46, 80, 1024, 256, 2)],
                         ids=["h23_tile_h1", "h46_tile_h2"])
def test_bf16_bottleneck_at_the_detr_heights(card, H, W, C, M, tile_h):
    x, ws = _bottleneck_case(1, H, W, C, M, torch.bfloat16, seed=H)
    _check_bottleneck(x, ws, fused_bottleneck(x, *ws, tile_h=tile_h))


@pytest.mark.parametrize(
    "H,M,tile_h,tile_w,rows",
    [(8, 64, 8, 16, 160), (8, 64, 8, 16, 128), (8, 64, 4, 16, 96), (8, 1024, 4, 16, 160), (10, 64, 4, 16, 160),
     (8, 64, 4, 0, 160)],
    ids=["ring_180_of_160_rows", "ring_180_of_128_rows", "no_such_tiles", "smem_over_227KB", "tile_h_not_dividing_H",
         "empty_patch"],
)
def test_bf16_bottleneck_launch_refuses_what_its_tiles_do_not_cover(card, H, M, tile_h, tile_w, rows):
    """The C entry point takes the tiles it is given and refuses, before it
    launches anything, a ring its warps' tiles do not cover, tiles it does
    not have, a block over 227 KB of shared memory, or rows of patches that
    do not tile the image."""
    lib = k3.load_library()
    x, ws = _bottleneck_case(1, H, 40, 256, M, torch.bfloat16)
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, *ws, out)]
    err = lib.fused_bottleneck(1, *ptrs, 1, H, 40, 256, M, tile_h, tile_w, rows,
                               torch.cuda.current_stream().cuda_stream)
    assert err != 0
    if H % tile_h == 0:
        _check_bottleneck(x, ws, fused_bottleneck(x, *ws, tile_h=tile_h))  # the plan's tiles still launch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width,channels,mid,tile_h",
                         [(320, 256, 64, 8), (160, 512, 128, 4), (80, 1024, 256, 2), (40, 2048, 512, 1), (20, 32, 8, 4)])
def test_bottleneck_smem_matches_the_library(card, dtype, width, channels, mid, tile_h):
    """The plan's shared bytes are what the launch requests, at the plan's
    tiles and at every other tile of the type."""
    lib = k3.load_library()
    code = 1 if dtype == torch.bfloat16 else 0
    rows, tile_w, smem = k3.plan(width, mid, tile_h, dtype, channels)
    assert lib.bottleneck_smem_bytes(code, rows, tile_h, tile_w, mid) == smem
    for other in k3.MMA_TILES if dtype == torch.bfloat16 else k3.GEMM_ROWS:
        assert lib.bottleneck_smem_bytes(code, other, tile_h, 5, mid) == k3.smem_bytes(other, tile_h, 5, mid, dtype)
    assert lib.bottleneck_smem_bytes(code, 96, tile_h, 5, mid) == -1
