"""The CUDA kernels (attention K1/K2, fused bottleneck K3) against their plain
version, on the card, and B.4 (attention under autograd: K1/K2 forward, the
backward kernel pair) against float64 autograd of the plain version. Also the
scan tracker's loop on the card against the CPU, with no host sync inside it.

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
sums (``bottleneck_kernel_bench.bf16_verdict``). B.4's dq/dk/dv against float64
autograd of the plain version on the same values, and against the pair's plain
version (``attention_backward_reference``): bf16 2^-6 relative to max(1, |ref|)
(the bf16 rounding of P, dS and the results), float32 1e-5 (summation order).
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
B4_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-6}
#: The forward's log-sum-exp against attention_lse, relative to max(1,
#: |lse|): float32 summation order; bf16 scores are summed on the tensor
#: cores from bf16 products, in another order than the plain version's.
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
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
#: Head dims above 128 (C.7), at a multiple of 64 and padded: the panel
#: bodies in float32 and bf16 K1, the in-line Hopper body in bf16 K2 up to
#: 256, and above 256 the panel bodies in two column panels (320, 384).
WIDE_DIMS = (136, 192, 256, 320, 384)
#: Lengths that cross the Hopper bodies' edges (bf16 at head dims 64 to
#: 256): 64-row warpgroups, 128-row blocks, K2's 128-key tiles (64 above
#: 128), the pair's 64-row tiles (32 at 256), and the ViT-base detect and
#: training token counts.
HOPPER_L = (1, 127, 128, 129, 3681, 4033)
#: Head dims the Hopper bodies take: 64, 128, 192 and 256, and 80 and 136
#: padded to 128 and 192.
HOPPER_DIMS = (64, 80, 128, 136, 192, 256)
#: Lengths across float32 K2's edges (the 3xTF32 body: 16-row warps, 64-row
#: blocks, 64-key tiles, 32 at head dim 128) and the pairs' 64- and 128-row
#: tiles: (Lq, Lk) every pair of these.
EDGE_LQ, EDGE_LK = (1, 63, 65, 127, 129, 300), (1, 63, 65, 127, 129, 260)


@pytest.mark.parametrize("fn", [kernels.attention_whole_kv, kernels.attention_flash])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [*kernels.HEAD_DIMS, 48, 80, *WIDE_DIMS])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_plain(card, fn, dtype, D, masked):
    _check_kernel(fn, *_case(2, 3, 67, 131, D, dtype, masked))


@pytest.mark.parametrize("fn", [kernels.attention_whole_kv, kernels.attention_flash])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,lengths", [*((d, "detr") for d in (*kernels.HEAD_DIMS, 48, 80, *WIDE_DIMS)),
                                       *((d, "hopper") for d in HOPPER_DIMS), (256, "vitw_train"),
                                       (64, "long"), (128, "long"), *((d, "edges") for d in kernels.HEAD_DIMS)])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_plain_at_tile_edges(card, fn, dtype, D, lengths, masked):
    """Every (Lq, Lk) pair of LQ x LK ("detr"), of HOPPER_L x HOPPER_L
    ("hopper"), or of EDGE_LQ x EDGE_LK ("edges": float32 K2's 3xTF32 body
    at every head dim up to 128); with the mask, batch entry 0 has every
    key masked (mean(V)).
    B * H = 6, so a tile that runs past L meets the next head's rows in
    device memory (the Hopper bodies' 3-D tensor maps must not read them).
    "vitw_train": (1, 4, 4033, 4033) at head dim 256, the VITW DETR's
    training tokens, where float32 K1 (the panel body, which takes any Lk)
    walks 64 key tiles in each of its two passes. "long": (1, 4, 4033, 4033)
    at 64 and (1, 8, 4033, 4033) at 128, which float32 K1 takes since it
    runs the panel body there.

    bf16 is held relative to max(1, |ref|): with 15 keys an output reaches
    2.6, and the two roundings of the Pallas kernels (probabilities, then
    the output, each half an ulp, 2^-9 relative) give 1.19e-2 absolute there
    in an exact emulation of K1's rounding on the CPU, which the kernel
    matches. float32 stays absolute (summation order only).
    """
    B, H, lqs, lks = {"detr": (2, 3, LQ, LK), "hopper": (2, 3, HOPPER_L, HOPPER_L), "edges": (2, 3, EDGE_LQ, EDGE_LK),
                      "vitw_train": (1, 4, (4033,), (4033,)),
                      "long": (1, 4 if D == 64 else 8, (4033,), (4033,))}[lengths]
    for i, lq in enumerate(lqs):
        for j, lk in enumerate(lks):
            if fn is kernels.attention_whole_kv and not kernels.whole_kv_fits(lk, D, dtype):
                continue
            _check_kernel(fn, *_case(B, H, lq, lk, D, dtype, masked, seed=10 * i + j),
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
    """multi_head_attention launches the kernel use_flash names: K2 at 920
    and at 100 keys in both types (float32 takes K2 at every head dim up to
    128, the 3xTF32 body)."""
    q, k, v, mask = _case(1, 2, 50, 920, 32, torch.float32, True)
    short = [t[:, :, :100].contiguous() for t in (k, v)]
    before = dict(kernels.launch_counts)
    multi_head_attention(q, k, v, mask)
    multi_head_attention(q, *short, mask[:, :100].contiguous())
    multi_head_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask)
    multi_head_attention(q.bfloat16(), *(t.bfloat16() for t in short), mask[:, :100].contiguous())
    assert kernels.launch_counts["attention_flash"] == before["attention_flash"] + 4
    assert kernels.launch_counts["attention_whole_kv"] == before["attention_whole_kv"]


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
                                 None, out.data_ptr(), None, 1, 1, 100, 100, 32, 32**-0.5, blocks, threads,
                                 torch.cuda.current_stream().cuda_stream)
    assert err != 0
    _check_kernel(kernels.attention_whole_kv, q, k, v, None)  # the plan's grid still launches


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    q, k, v, _ = _case(1, 2, 8, 8, 32, torch.float32, False)
    # head dim 136 raised until C.7 closed; it now runs the panel body (padded to 192)
    _check_kernel(kernels.attention_flash, *_case(1, 2, 8, 8, 136, torch.float32, False))
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
    print(f"K3 bf16 {tuple(x.shape)}: bar reading (against exact sums) {readings[1]:.3e}; float32 sums "
          f"(diagnostic) {readings[0]:.3e}, themselves {readings[2]:.3e} from exact")
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


def test_kernels_refuse_inputs_that_require_grad(card):
    """Their output would carry no gradient (ROADMAP B.4): the launch path
    refuses, and runs under inference_mode."""
    q, k, v = (torch.randn(1, 2, 32, 16, device="cuda") for _ in range(3))
    k.requires_grad_(True)
    with pytest.raises(RuntimeError, match="B.4"):
        kernels.attention_flash(q, k, v)
    with pytest.raises(RuntimeError, match="B.4"):
        kernels.attention_whole_kv(q, k, v)
    with torch.inference_mode():
        kernels.attention_flash(q, k, v)
    x, ws = _bottleneck_case(1, 4, 8, 64, 16, torch.float32)
    ws[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="B.4"):
        fused_bottleneck(x, *ws, tile_h=4)


def _b4_errors(got, want):
    """The larger of relative_errors' two readings over dq, dk, dv: each
    element relative to max(1, |want|), each tensor relative to its max."""
    from office_person_detection_vit_torch.attention_kernel_bench import relative_errors

    return max(relative_errors(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq,Lk,D", [(84, 84, 16), (100, 1008, 32), (67, 131, 32), (37, 53, 16), (131, 67, 64),
                                     (100, 1008, 64), (37, 53, 48), (131, 67, 128), (100, 1008, 128),
                                     (37, 53, 80), (131, 67, 136), (100, 260, 192), (67, 131, 256),
                                     (1, 127, 64), (127, 129, 64), (129, 128, 80), (128, 127, 128), (1, 129, 128),
                                     (3681, 4033, 64), (4033, 3681, 128), (1, 129, 192), (129, 65, 192),
                                     (33, 31, 256), (127, 129, 256), (4033, 3681, 256), (131, 67, 320),
                                     (131, 67, 384), (1008, 1008, 256), (1, 129, 320), (63, 65, 384),
                                     (65, 63, 320), (127, 129, 384), (129, 127, 320), (300, 260, 384)])
@pytest.mark.parametrize("all_masked", [False, True], ids=["ragged", "all_masked_entry"])
def test_b4_gradients_match_plain_autograd(card, dtype, Lq, Lk, D, all_masked):
    """B.4: multi_head_attention under grad runs K1/K2 through
    KernelAttention and its backward through the kernel pair, once each;
    dq/dk/dv are held against float64 autograd of the plain version on the
    same values and against the pair's plain version at B4_TOL (the forward
    at the kernel's bar against the plain version in float32). With
    ``all_masked`` batch entry 0 has every key masked: uniform probabilities,
    and dq, dk not zero. The Hopper pair's edges (64-row warpgroups, 128-row
    blocks, 64-row tiles, 32-row ones at D 256; ViT-base's 3681 and 4033
    tokens) are here, and the bf16 pair above 256 on column panels at 320
    and 384 (128-row dQ blocks, 64-key tiles, 128-key dK/dV blocks, 64-row
    query tiles), each with a
    single query; a single key is held in the forward tests only, since
    there every row's P is 1 and dq, dk vanish: the bar's second reading
    (relative to the largest |ref|) would divide rounding by rounding."""
    _check_b4(dtype, Lq, Lk, D, all_masked)


#: (Lq, Lk) across the float32 3xTF32 pair's edges: 16-row warps, 64-row dQ
#: blocks and 64-key dK/dV blocks, key and query tiles of 64, 32 and 16
#: rows (D 16/32, 64, 128), and a single query.
TF32_PAIR_L = ((1, 15), (15, 17), (17, 15), (63, 65), (65, 63), (127, 129), (129, 127), (300, 260))


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("Lq,Lk", [*TF32_PAIR_L, (4033, 3681)])
@pytest.mark.parametrize("all_masked", [False, True], ids=["ragged", "all_masked_entry"])
def test_tf32_pair_matches_plain_autograd_at_tile_edges(card, D, Lq, Lk, all_masked):
    """The float32 pair up to head dim 128 (attention_bwd_{dq,dkdv}_tf32,
    three TF32 products a float32 product) through B.4 at its tile edges,
    with a ragged mask and an all-masked entry, against float64 autograd
    and the pair's plain version at 1e-5 (test_b4_gradients_match_plain_
    autograd's checks); 4033 query rows summed into dK and dV and 3681 keys
    into dQ, for the tensor cores' accumulation (each group of 32 summed
    apart)."""
    assert kernels.is_tf32_pair(D, torch.float32)
    _check_b4(torch.float32, Lq, Lk, D, all_masked)


def _check_b4(dtype, Lq, Lk, D, all_masked):
    from office_person_detection_vit_torch.ops import attention as oa

    q, k, v, mask = _case(2, 2, Lq, Lk, D, dtype, True, seed=5)
    mask[0] = not all_masked
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    g = torch.randn_like(q)
    before = dict(kernels.launch_counts)
    oa.reset_launch_counts()
    out = multi_head_attention(q, k, v, mask)
    assert type(out.grad_fn).__name__ == "KernelAttentionBackward" and oa.launch_counts["attention_diff"] == 1
    assert sum(kernels.launch_counts.values()) == sum(before.values()) + 1
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert kernels.launch_counts["attention_backward"] == before["attention_backward"] + 1
    assert sum(kernels.launch_counts.values()) == sum(before.values()) + 2
    x64 = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_reference(*x64, mask), x64, g.double())
    f32 = [t.detach().float() for t in (q, k, v)]
    fwd = attention_reference(*f32, mask)
    lse = oa.attention_lse(*f32[:2], mask)
    twin = oa.attention_backward_reference(*f32, mask, out.detach().float(), lse, g.float())
    assert (out.float() - fwd).abs().max().item() <= TOL[dtype]
    assert all(a.dtype == dtype and bool(torch.isfinite(a).all()) for a in grads)
    assert _b4_errors(grads, want) <= B4_TOL[dtype]
    assert _b4_errors(grads, twin) <= B4_TOL[dtype]
    if all_masked:
        assert all(a[0].abs().max().item() > 1e-3 for a in grads[:2])


@pytest.mark.parametrize(
    "fn,dtype,Lq,Lk,D",
    [(kernels.attention_flash, torch.bfloat16, 67, 131, 32), (kernels.attention_flash, torch.bfloat16, 920, 920, 32),
     (kernels.attention_flash, torch.bfloat16, 100, 1008, 32), (kernels.attention_flash, torch.bfloat16, 37, 53, 16),
     (kernels.attention_flash, torch.float32, 67, 131, 32), (kernels.attention_flash, torch.float32, 84, 84, 16),
     (kernels.attention_whole_kv, torch.float32, 67, 131, 32), (kernels.attention_whole_kv, torch.float32, 84, 84, 16),
     (kernels.attention_whole_kv, torch.float32, 25, 84, 16), (kernels.attention_flash, torch.bfloat16, 197, 197, 64),
     (kernels.attention_flash, torch.float32, 67, 131, 64), (kernels.attention_whole_kv, torch.float32, 67, 131, 64),
     (kernels.attention_flash, torch.bfloat16, 67, 131, 48), (kernels.attention_whole_kv, torch.float32, 67, 131, 48),
     (kernels.attention_flash, torch.bfloat16, 67, 131, 192), (kernels.attention_whole_kv, torch.bfloat16, 67, 131, 256),
     (kernels.attention_flash, torch.float32, 67, 131, 160), (kernels.attention_whole_kv, torch.float32, 67, 131, 192),
     (kernels.attention_flash, torch.bfloat16, 1, 129, 64), (kernels.attention_flash, torch.bfloat16, 129, 127, 64),
     (kernels.attention_flash, torch.bfloat16, 3681, 3681, 64), (kernels.attention_flash, torch.bfloat16, 128, 1, 80),
     (kernels.attention_flash, torch.bfloat16, 127, 128, 128), (kernels.attention_flash, torch.bfloat16, 4033, 4033, 128),
     (kernels.attention_whole_kv, torch.bfloat16, 129, 67, 192), (kernels.attention_flash, torch.bfloat16, 67, 131, 320),
     (kernels.attention_whole_kv, torch.bfloat16, 131, 67, 384), (kernels.attention_whole_kv, torch.float32, 67, 131, 384),
     (kernels.attention_flash, torch.float32, 131, 67, 320), (kernels.attention_flash, torch.bfloat16, 300, 260, 384),
     (kernels.attention_whole_kv, torch.float32, 131, 67, 128), (kernels.attention_whole_kv, torch.float32, 197, 197, 80),
     (kernels.attention_whole_kv, torch.float32, 50, 50, 64), (kernels.attention_whole_kv, torch.float32, 1, 1000, 64),
     (kernels.attention_flash, torch.float32, 1, 63, 16), (kernels.attention_flash, torch.float32, 63, 65, 32),
     (kernels.attention_flash, torch.float32, 65, 127, 64), (kernels.attention_flash, torch.float32, 129, 1, 128),
     (kernels.attention_flash, torch.float32, 127, 129, 128), (kernels.attention_flash, torch.float32, 300, 260, 128),
     (kernels.attention_flash, torch.float32, 300, 260, 16), (kernels.attention_flash, torch.float32, 129, 65, 32)],
    ids=["k2_bf16_67x131", "k2_bf16_encoder_920", "k2_bf16_cross_1008", "k2_bf16_d16", "k2_float32_67x131",
         "k2_float32_d16", "k1_float32_67x131", "k1_float32_d16", "k1_float32_cross_d16", "k2_bf16_d64",
         "k2_float32_d64", "k1_float32_d64", "k2_bf16_d48", "k1_float32_d48", "k2_bf16_d192", "k1_bf16_d256",
         "k2_float32_d160", "k1_float32_d192", "k2_bf16_d64_1x129", "k2_bf16_d64_129x127", "k2_bf16_d64_vit_3681",
         "k2_bf16_d80_128x1", "k2_bf16_d128_127x128", "k2_bf16_d128_4033", "k1_bf16_d192", "k2_bf16_d320",
         "k1_bf16_d384", "k1_float32_d384", "k2_float32_d320", "k2_bf16_d384_300x260", "k1_float32_d128",
         "k1_float32_d80_vit_h", "k1_float32_d64_clip", "k1_float32_d64_1x1000", "k2_float32_d16_1x63",
         "k2_float32_d32_63x65", "k2_float32_d64_65x127", "k2_float32_d128_129x1", "k2_float32_d128_127x129",
         "k2_float32_d128_300x260", "k2_float32_d16_300x260", "k2_float32_d32_129x65"],
)
def test_forward_with_lse_is_bit_identical(card, fn, dtype, Lq, Lk, D):
    """K2 (both types) and K1 (float32, and bf16 above head dim 128) give
    the same bits with and without the lse pointer, which the detect path
    leaves null, and the lse they write matches attention_lse (batch entry 0
    has every key masked: log Lk). Above 256 the lse comes from the z = 0
    panel."""
    from office_person_detection_vit_torch.ops.attention import attention_lse

    q, k, v, mask = _case(2, 3, Lq, Lk, D, dtype, True, seed=7)
    plain = fn(q, k, v, mask)
    out, lse = fn(q, k, v, mask, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(plain, out)
    want = attention_lse(q, k, mask)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    assert ((lse - want).abs() / want.abs().clamp(min=1.0)).max().item() <= LSE_TOL[dtype]



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_plan_matches_the_library(card, dtype):
    """kernels/attention.py::panel_forward_plan mirrors the source's panel
    plan (attention_forward_plan) at every multiple of 64 from 192 to 1024,
    and in float32 at 64 and 128 (K1), and the library refuses head dims the
    panel bodies do not take (bf16 at 128, float32 at 32)."""
    for d in [*((64, 128) if dtype == torch.float32 else ()), *range(192, 1025, 64)]:
        mine = kernels.panel_forward_plan(d, dtype)
        assert kernels.library_forward_plan(d, dtype) == {k: mine[k] for k in ("panels", "panel_cols", "acc_cols",
                                                                                 "smem_bytes", "widths")}
    with pytest.raises(ValueError):
        kernels.library_forward_plan(32 if dtype == torch.float32 else 128, dtype)


def test_pair_plan_matches_the_library(card):
    """kernels/attention.py::pair_backward_plan mirrors the float32 pair's
    launch (attention_backward_plan) at every multiple of 64 from 192 to
    1024, and the library refuses 128."""
    for d in range(192, 1025, 64):
        mine = kernels.pair_backward_plan(d)
        lib = kernels.library_backward_plan(d)
        assert lib == {k: mine[k] for k in lib}
    with pytest.raises(ValueError):
        kernels.library_backward_plan(128)


def test_float32_k1_bodies_fit_their_blocks_an_sm(card):
    """The register-tiled float32 K1 at 64 and 128 compiles within its
    launch bounds with no spill: three blocks of 256 threads an SM at 64
    (at most 80 registers a thread), two at 128 (at most 128), as the plan's
    shared memory allows."""
    rows = {a["name"]: a for a in kernels.kernel_attributes()}
    for d, blocks in ((64, 3), (128, 2)):
        a = rows[f"attention_panels_fma<float,{d},K1>"]
        assert a["local_bytes"] == 0 and a["regs"] * 256 * blocks <= 65_536
        assert kernels.blocks_an_sm(kernels.panel_forward_plan(d, torch.float32)["smem_bytes"]) >= blocks


@pytest.mark.parametrize("fn", [kernels.attention_whole_kv, kernels.attention_flash])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [320, 384, 640])
def test_panels_match_plain_and_are_deterministic(card, fn, dtype, D):
    """Above head dim 256 the panel bodies split the output into column
    panels on grid z (640: 224, 224 and 192, the last narrower): each panel
    within the bar of the plain version, and two calls bit-identical."""
    q, k, v, mask = _case(2, 3, 131, 197, D, dtype, True, seed=13)
    _check_kernel(fn, q, k, v, mask, relative=dtype == torch.bfloat16)
    assert torch.equal(fn(q, k, v, mask), fn(q, k, v, mask))

def test_k1_bf16_refuses_lse(card):
    q, k, v, _ = _case(1, 2, 50, 100, 32, torch.bfloat16, False)
    with pytest.raises(ValueError, match="log-sum-exp"):
        kernels.attention_whole_kv(q, k, v, with_lse=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64, 48, 128, 192, 80, 256, 320, 384])
@pytest.mark.parametrize("Lq,Lk", [(300, 260), (4033, 3681)])
def test_backward_pair_is_deterministic(card, dtype, D, Lq, Lk):
    """Two calls of the pair on the same inputs give the same bits (no
    atomics), at shapes with several blocks per head both ways."""
    q, k, v, mask = _case(2, 4, Lq, Lk, D, dtype, True, seed=9)
    out, lse = kernels.attention_flash(q, k, v, mask, with_lse=True)
    g = torch.randn_like(q)
    first = kernels.attention_backward(q, k, v, mask, out, lse, g)
    second = kernels.attention_backward(q, k, v, mask, out, lse, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("D", [64, 128, 256, 320])
def test_hopper_bodies_launch_from_a_fresh_thread(card, D):
    """The Hopper bodies encode their TMA maps with the driver, which needs a
    current context; a thread whose first CUDA call is one of them has none
    until the launch binds the tensors' device (autograd runs a backward on a
    thread of its own). K2 and the pair from a new thread match the calls
    from this one bit for bit."""
    import threading

    q, k, v, mask = _case(1, 12, 300, 260, D, torch.bfloat16, True, seed=11)
    g = torch.randn_like(q)
    here = kernels.attention_flash(q, k, v, mask, with_lse=True)
    here_grads = kernels.attention_backward(q, k, v, mask, *here, g)
    got = {}

    def run():
        out = kernels.attention_flash(q, k, v, mask, with_lse=True)
        got["fwd"], got["grads"] = out, kernels.attention_backward(q, k, v, mask, *out, g)
        torch.cuda.synchronize()

    t = threading.Thread(target=run)
    t.start()
    t.join()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got["fwd"], here))
    assert all(torch.equal(a, b) for a, b in zip(got["grads"], here_grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64, 128, 192, 256, 320, 384])
@pytest.mark.parametrize("Lq", [1, 127, 128, 129])
def test_backward_fills_the_scratch_the_library_sizes(card, dtype, D, Lq):
    """attention_backward_scratch_rows is the one rule for the pair's
    scratch: at least Lq rows a (batch*head), each of which the dQ kernel
    writes (the padded rows too, which the dK/dV kernel reads in whole
    tiles), and nothing past them. A scratch of that size filled with NaN,
    with a NaN guard after it, comes back with no NaN and the guard
    untouched, and the gradients are the wrapper's to the bit."""
    import math

    q, k, v, mask = _case(2, 3, Lq, 131, D, dtype, True, seed=12)
    out, lse = kernels.attention_flash(q, k, v, mask, with_lse=True)
    g = torch.randn_like(q)
    lib = kernels.load_library()
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    rows = lib.attention_backward_scratch_rows(code, Lq, D)
    assert rows >= Lq
    used = 2 * 2 * 3 * rows
    scratch = torch.full((used + 4096,), float("nan"), device="cuda")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = lib.attention_backward(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                                 lse.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                 scratch.data_ptr(), 2, 3, Lq, 131, D, 1.0 / math.sqrt(D),
                                 torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert not bool(scratch[:used].isnan().any()) and bool(scratch[used:].isnan().all())
    want = kernels.attention_backward(q, k, v, mask, out, lse, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), want))


#: (Lq, Lk) across the narrow Hopper bodies' edges (bf16 K2 and the pair at
#: head dims 16 and 32): 64-row warpgroups, one-warpgroup blocks up to 192
#: rows (kNarrowOneWgUpto) and two-warpgroup ones above, 64-key and
#: 64-query ring tiles, and DETR-R50's 100, 920 and 1008 tokens.
NARROW_L = ((1, 65), (63, 64), (100, 100), (100, 920), (192, 193), (193, 129), (920, 920), (1008, 1008),
            (100, 1008))


@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("Lq,Lk", NARROW_L)
def test_narrow_bodies_match_plain_at_their_edges(card, D, Lq, Lk):
    """bf16 K2 and the pair at head dims 16 and 32 run the narrow Hopper
    bodies (``attention_*_wgmma_narrow``): with a ragged mask and batch
    entry 0 all masked (mean(V) there), K2 within 1e-2 of the plain version
    and its lse within 1e-4 of attention_lse, the same bits with and
    without the lse and from call to call; the pair's dq/dk/dv within 2^-6
    of float64 autograd and of its plain version, the same bits from call
    to call."""
    from office_person_detection_vit_torch.ops.attention import attention_backward_reference, attention_lse

    assert kernels.is_wgmma_forward(D, torch.bfloat16) and kernels.is_wgmma_pair(D, torch.bfloat16)
    q, k, v, mask = _case(2, 3, Lq, Lk, D, torch.bfloat16, True, seed=13)
    plain = kernels.attention_flash(q, k, v, mask)
    out, lse = kernels.attention_flash(q, k, v, mask, with_lse=True)
    again = kernels.attention_flash(q, k, v, mask, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(plain, out) and torch.equal(again[0], out) and torch.equal(again[1], lse)
    f32 = [t.float() for t in (q, k, v)]
    want = attention_reference(*f32, mask)
    assert bool(torch.isfinite(out).all()) and (out.float() - want).abs().max().item() <= TOL[torch.bfloat16]
    assert (out[0].float() - f32[2][0].mean(dim=-2, keepdim=True)).abs().max().item() <= TOL[torch.bfloat16]
    want_lse = attention_lse(*f32[:2], mask)
    assert ((lse - want_lse).abs() / want_lse.abs().clamp(min=1.0)).max().item() <= LSE_TOL[torch.bfloat16]
    g = torch.randn_like(q)
    grads = kernels.attention_backward(q, k, v, mask, out, lse, g)
    twice = kernels.attention_backward(q, k, v, mask, out, lse, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, twice))
    assert all(a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all()) for a in grads)
    x64 = [t.double().requires_grad_(True) for t in (q, k, v)]
    exact = torch.autograd.grad(attention_reference(*x64, mask), x64, g.double())
    twin = attention_backward_reference(*f32, mask, out.float(), lse, g.float())
    assert _b4_errors(grads, exact) <= B4_TOL[torch.bfloat16]
    assert _b4_errors(grads, twin) <= B4_TOL[torch.bfloat16]


@pytest.mark.parametrize("D", [16, 32])
def test_narrow_bodies_take_more_heads_than_a_grid_row(card, D):
    """The narrow bodies put B*H on the grid's x (up to 2^31 - 1), not on y
    (up to 65535): at B*H = 65600 (two row blocks, ragged), K2's output and
    lse and the pair's dq/dk/dv of the first and the last heads of each
    batch entry are the bits of the same heads run alone (a block's work
    does not depend on where the grid puts it)."""
    B, H = 2, 32800
    q, k, v, mask = _case(B, H, 65, 64, D, torch.bfloat16, True, seed=17)
    g = torch.randn_like(q)
    out, lse = kernels.attention_flash(q, k, v, mask, with_lse=True)
    grads = kernels.attention_backward(q, k, v, mask, out, lse, g)
    for heads in (slice(0, 3), slice(H - 3, H)):
        part = [t[:, heads].contiguous() for t in (q, k, v)]
        out_p, lse_p = kernels.attention_flash(*part, mask, with_lse=True)
        assert torch.equal(out_p, out[:, heads]) and torch.equal(lse_p, lse[:, heads])
        grads_p = kernels.attention_backward(*part, mask, out_p, lse_p, g[:, heads].contiguous())
        assert all(torch.equal(a, b[:, heads]) for a, b in zip(grads_p, grads))


def test_backward_wrapper_rejects_what_the_pair_does_not_take(card):
    q, k, v, mask = _case(1, 2, 40, 70, 32, torch.float32, True)
    out, lse = kernels.attention_flash(q, k, v, mask, with_lse=True)
    g = torch.randn_like(q)
    with pytest.raises(ValueError, match="lse"):
        kernels.attention_backward(q, k, v, mask, out, lse.double(), g)
    with pytest.raises(ValueError, match="g must match"):
        kernels.attention_backward(q, k, v, mask, out, lse, g.bfloat16())
    with pytest.raises(ValueError, match="out must"):
        kernels.attention_backward(q, k, v, mask, out.transpose(2, 3).contiguous().transpose(2, 3), lse, g)


def test_attention_map_leaves_detect_launch_counts(card):
    """get_attention_map runs the last cross-attention on the plain version
    for that one call; detect_batch launches the same kernels after it."""
    import numpy as np

    from office_person_detection_vit_torch.detection.detector import DETRDetector
    from office_person_detection_vit_torch.models.detr import DETRConfig

    det = DETRDetector({"detection.device": "cuda", "detection.batch_size": 2, "detection.input_height": 96,
                        "detection.input_width": 128}, detr_config=DETRConfig.tiny(dtype="bfloat16"))
    frames = np.random.default_rng(0).integers(0, 256, (2, 120, 160, 3), np.uint8)
    counts = []
    for _ in range(2):
        kernels.reset_launch_counts()
        det.detect_batch(frames)
        counts.append(dict(kernels.launch_counts))
        amap = det.get_attention_map(frames[0])
        assert amap.shape == det.feature_hw and np.isfinite(amap).all()
    assert counts[0] == counts[1] and sum(counts[0].values()) == 6  # 2 encoder, 2 + 2 decoder calls


@pytest.mark.parametrize("features", [True, False])
def test_scan_tracker_on_the_card_matches_the_cpu(features):
    """The scan tracker's whole loop on the card, under
    ``set_sync_debug_mode("error")`` (any host synchronisation inside it
    raises): the same (F, D) ids as on the CPU, and the same final state
    (the cost's products are summed in float64 and rounded, everything else
    is elementwise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from office_person_detection_vit_torch.tracking import scan_tracker as scan

    rng = np.random.default_rng(3)
    F, D, people, Fd = 60, 12, 9, 64
    pos = rng.uniform([0, 0], [1200, 600], (people, 2))
    looks = rng.normal(size=(people, Fd))
    boxes = np.zeros((F, D, 4), np.float32)
    conf = np.zeros((F, D), np.float32)
    valid = np.zeros((F, D), bool)
    feats = np.zeros((F, D, Fd if features else 1), np.float32)
    for f in range(F):
        pos += rng.normal(0, 6, pos.shape)
        for k, p in enumerate(rng.permutation(people)[: rng.integers(6, people + 1)]):
            boxes[f, k] = [*(pos[p] + rng.normal(0, 2, 2)), 50, 150]
            conf[f, k], valid[f, k] = rng.uniform(0.2, 0.95), True
            if features:
                v = looks[p] + rng.normal(0, 0.3, Fd)
                feats[f, k] = v / np.linalg.norm(v)
    arrays = (boxes, conf, valid, feats, np.full((F,), 10.0, np.float32))
    kw = {"min_hits": 2, "max_age": 5}
    cpu_state, cpu_ids = scan.scan_track(scan.init_state(16, feats.shape[-1]), *map(torch.from_numpy, arrays), **kw)
    inputs = [torch.from_numpy(a).cuda() for a in arrays]
    state = scan.init_state(16, feats.shape[-1], "cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, ids = scan.scan_track(state, *inputs, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ids.is_cuda and state.kf_x.is_cuda
    assert torch.equal(ids.cpu(), cpu_ids) and (cpu_ids > 0).sum() > valid.sum() // 2
    for name, value in scan.state_to_numpy(state).items():
        np.testing.assert_array_equal(value, getattr(cpu_state, name).numpy(), err_msg=name)
