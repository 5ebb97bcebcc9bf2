"""Port fused bottleneck (K3's module) against the JAX package on the CPU.

The same numpy-seeded inputs go to JAX ``bottleneck_reference`` / the Pallas
``fused_bottleneck`` (in interpret mode, as tests/test_fused_bottleneck.py
runs it) and to the port, where CPU tensors take the plain version.
Tolerances: float32 1e-4 atol/rtol, the JAX test's own bar; bf16 against
the float32 reference 0.15 absolute (the JAX test's bar, operand rounding);
bf16 against JAX's bf16 reference 2^-6 relative to max(1, |ref|): the two
round y1, y2 and the output at the same points and sum in another order, so
a value next to a rounding midpoint may round the other way, one ulp (at
most 2^-7 relative) in the output plus one in y1 or y2 carried through the
next product. The fold of a port ``Bottleneck`` holds against the module's
own forward at 1e-4 relative to max(1, |ref|): folding reorders one multiply.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch import bottleneck_kernel_bench as bench
from office_person_detection_vit_torch import bottleneck_phase_profile as profile
from office_person_detection_vit_torch.kernels import bottleneck as kernels
from office_person_detection_vit_torch.kernels import build
from office_person_detection_vit_torch.kernels.build import BLOCK_SMEM_BYTES
from office_person_detection_vit_torch.models.resnet import Bottleneck
from office_person_detection_vit_torch.ops import fused_bottleneck as port
from office_person_detection_vit_tpu.ops import fused_bottleneck as ref
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

BF16_REL = 2.0**-6


def _inputs(seed, B, H, W, C, M, b1=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    ws = [rng.normal(0, 0.1, s).astype(np.float32) for s in ((C, M), (M,), (3, 3, M, M), (M,), (M, C), (C,))]
    if b1 is not None:
        ws[1] = np.full((M,), b1, np.float32)  # relu(b1) != 0 at any pad pixel
    return x, ws


def _port(fn, x, ws, dtype=torch.float32, **kw):
    t = [torch.from_numpy(x).to(dtype)] + [
        torch.from_numpy(w).to(dtype) if w.ndim > 1 else torch.from_numpy(w) for w in ws
    ]
    return fn(*t, **kw).float().numpy()


def _jax(fn, x, ws, dtype=jnp.float32, **kw):
    a = [jnp.asarray(x, dtype)] + [jnp.asarray(w, dtype) if w.ndim > 1 else jnp.asarray(w) for w in ws]
    return np.asarray(fn(*a, **kw).astype(jnp.float32))


def _rel_err(got, want):
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


@pytest.mark.parametrize("shape", [(2, 16, 12, 32, 8), (1, 8, 6, 16, 8), (1, 6, 10, 64, 16)])
def test_reference_matches_jax_reference(shape):
    x, ws = _inputs(0, *shape)
    np.testing.assert_allclose(_port(port.bottleneck_reference, x, ws),
                               _jax(ref.bottleneck_reference, x, ws), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("tile_h", [4, 8])
def test_fused_matches_jax_pallas(tile_h):
    x, ws = _inputs(0, 2, 16, 12, 32, 8)
    got = _port(port.fused_bottleneck, x, ws, tile_h=tile_h)
    want = _jax(ref.fused_bottleneck, x, ws, tile_h=tile_h, interpret=True)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("oracle", ["pallas", "reference"])
def test_border_rows_match_same_padding(oracle):
    """SAME padding is zero in y1: with b1 = 3 a wrong pad would leak relu(b1)
    into rows 0 and H-1."""
    x, ws = _inputs(1, 1, 8, 6, 16, 8, b1=3.0)
    got = _port(port.fused_bottleneck, x, ws, tile_h=4)
    if oracle == "pallas":
        want = _jax(ref.fused_bottleneck, x, ws, tile_h=4, interpret=True)
    else:
        want = _jax(ref.bottleneck_reference, x, ws)
    for rows in (np.s_[:, 0], np.s_[:, -1], np.s_[:]):
        np.testing.assert_allclose(got[rows], want[rows], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("oracle", ["float32_reference", "bfloat16_reference"])
def test_bf16(oracle):
    x, ws = _inputs(2, 1, 8, 8, 32, 8)
    got = _port(port.fused_bottleneck, x, ws, dtype=torch.bfloat16, tile_h=4)
    if oracle == "float32_reference":
        want = _jax(ref.bottleneck_reference, x, ws)
        assert np.abs(got - want).max() < 0.15  # bf16 operand noise only
    else:
        want = _jax(ref.bottleneck_reference, x, ws, dtype=jnp.bfloat16)
        assert _rel_err(got, want) <= BF16_REL


@pytest.mark.parametrize("fn", [port.fused_bottleneck, kernels.fused_bottleneck])
@pytest.mark.parametrize("H,tile_h", [(10, 4), (9, 2), (8, 0)])
def test_rejects_unaligned_tile(fn, H, tile_h):
    x, ws = _inputs(0, 1, H, 8, 16, 8)
    with pytest.raises(ValueError, match="divisible"):
        _port(fn, x, ws, tile_h=tile_h)


def test_cpu_tensors_take_the_plain_version():
    x, ws = _inputs(3, 1, 8, 5, 16, 8)
    np.testing.assert_array_equal(_port(kernels.fused_bottleneck, x, ws, tile_h=2),
                                  _port(port.bottleneck_reference, x, ws))


def test_non_cuda_device_raises():
    """A tensor that is not on the CPU takes the kernel path, which raises on
    anything but a CUDA tensor instead of falling back to the plain version."""
    x = torch.empty(1, 8, 8, 16, device="meta")
    w = [torch.empty(s, device="meta") for s in ((16, 8), (8,), (3, 3, 8, 8), (8,), (8, 16), (16,))]
    with pytest.raises(ValueError, match="CUDA tensors"):
        port.fused_bottleneck(x, *w)


def _random_block(seed, C, M, **kw):
    g = torch.Generator().manual_seed(seed)
    block = Bottleneck(C, M, C, **kw).eval()
    with torch.no_grad():
        for conv in (block.conv0, block.conv1, block.conv2):
            conv.weight.normal_(0.0, conv.weight[0].numel() ** -0.5, generator=g)
        for bn in (block.bn0, block.bn1, block.bn2):
            bn.scale.uniform_(0.5, 1.5, generator=g)
            bn.bias.normal_(0.0, 0.5, generator=g)
    return block


@pytest.mark.parametrize("via", ["port", "jax_pallas"])
@pytest.mark.parametrize("C,M", [(32, 8), (64, 16)])
def test_fold_matches_module_forward(via, C, M):
    """The folded weights through the fused block (the port's, or the JAX
    Pallas kernel's in interpret mode) give the unfolded module's output."""
    block = _random_block(4, C, M)
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (2, 8, 6, C)).astype(np.float32))
    with torch.no_grad():
        want = block(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    ws = [w.numpy() for w in port.fold_identity_bottleneck(block)]
    if via == "port":
        got = _port(port.fused_bottleneck, x.numpy(), ws, tile_h=4)
    else:
        got = _jax(ref.fused_bottleneck, x.numpy(), ws, tile_h=4, interpret=True)
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("kw", [dict(C=16, out=32), dict(C=32, out=32, stride=2), dict(C=32, out=32, dilation=2)],
                         ids=["projection", "stride2", "dilation2"])
def test_fold_refuses_what_the_kernel_does_not_compute(kw):
    kw = dict(kw)
    block = Bottleneck(kw.pop("C"), 8, kw.pop("out"), **kw)
    with pytest.raises(ValueError, match="fused bottleneck takes"):
        port.fold_identity_bottleneck(block)


def test_fold_layouts_and_types():
    block = _random_block(5, 32, 8).to(torch.bfloat16)
    w1, b1, w2, b2, w3, b3 = port.fold_identity_bottleneck(block)
    assert [tuple(t.shape) for t in (w1, b1, w2, b2, w3, b3)] == [(32, 8), (8,), (3, 3, 8, 8), (8,), (8, 32), (32,)]
    assert [t.dtype for t in (w1, w2, w3)] == [torch.bfloat16] * 3
    assert [t.dtype for t in (b1, b2, b3)] == [torch.float32] * 3
    # w2[ky, kx, i, o] = conv1.weight[o, i, ky, kx] * bn1.scale[o]
    want = block.conv1.weight.float()[5, 3, 2, 0] * block.bn1.scale[5]
    assert w2[2, 0, 3, 5].float().item() == pytest.approx(want.bfloat16().float().item())


# DETR-R50 stages at 736x1280: (width, C, M, tile_h); the float32 plan's (rows,
# tile_w, shared bytes); and the tile_w of the bf16 plan of the CUDA-core
# body that the tensor-core body replaced (tile_h x tile_w pixels a block).
PLANS = [
    ((320, 256, 64, 8), (64, 8, 58_880), 8),
    ((320, 256, 64, 4), (64, 16, 60_928), 16),
    ((160, 512, 128, 4), (64, 16, 104_960), 16),
    ((80, 1024, 256, 2), (16, 8, 92_672), 16),
    ((40, 2048, 512, 1), (16, 16, 178_688), 16),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("geometry,f32,cuda_core_tile_w", PLANS)
def test_plan_fits_a_block(dtype, geometry, f32, cuda_core_tile_w):
    """float32 keeps its plan exactly. bf16: the ring fits the tiles, the
    block fits 227 KB (half an SM's shared memory for the two-block tiles),
    and a block holds at least as many pixels as the CUDA-core body's did."""
    width, channels, mid, tile_h = geometry
    rows, tile_w, smem = kernels.plan(width, mid, tile_h, dtype, channels)
    assert smem == kernels.smem_bytes(rows, tile_h, tile_w, mid, dtype) and smem <= BLOCK_SMEM_BYTES
    if dtype == torch.float32:
        assert (rows, tile_w, smem) == f32 and tile_h * tile_w <= rows
        return
    assert rows in kernels.MMA_TILES and (tile_h + 2) * (tile_w + 2) <= rows and tile_w <= width
    if kernels.MMA_TILES[rows][2] == 2:
        assert smem <= kernels.TWO_BLOCK_SMEM_BYTES
    assert tile_w >= cuda_core_tile_w


# DETR-R50's identity-block stages at 736x1280, batch 8: (B, H, W, C, M,
# tile_h) and the bf16 plan's (rows, tile_h x tile_w).
DETR_STAGES = [
    ((8, 184, 320, 256, 64, 8), (160, 8, 14)),
    ((8, 92, 160, 512, 128, 4), (128, 4, 16)),
    ((8, 46, 80, 1024, 256, 2), (128, 2, 27)),
    ((8, 23, 40, 2048, 512, 1), (128, 1, 40)),
]


@pytest.mark.parametrize("geometry,tiles", DETR_STAGES, ids=["stage1", "stage2", "stage3", "stage4"])
def test_bf16_plan_report_at_the_detr_stages(geometry, tiles):
    """The tiles the plan picks, and the report's numbers from them: the
    grid covers the image, every block reads W1, W2 and W3 once from L2."""
    B, H, W, C, M, tile_h = geometry
    r = kernels.plan_report(B, H, W, C, M, tile_h, torch.bfloat16)
    assert (r["rows"], r["tile_h"], r["tile_w"]) == tiles
    patches = -(-W // r["tile_w"])
    assert patches * r["tile_w"] >= W > (patches - 1) * r["tile_w"]
    assert r["blocks"] == B * (H // tile_h) * patches and r["pixels"] == tile_h * r["tile_w"]
    assert r["weight_l2_bytes"] == r["blocks"] * (2 * C * M + 9 * M * M) * 2
    assert r["recompute"] == pytest.approx((tile_h + 2) * (r["tile_w"] + 2) / r["pixels"])
    assert r["smem_bytes"] == kernels.smem_bytes(r["rows"], tile_h, r["tile_w"], M, torch.bfloat16)


def test_build_digest_covers_the_headers(tmp_path):
    """The cached library's key changes with a header's bytes, as with a
    source's; only the .cu files are compiled."""
    for src in (*build.CSRC.glob("*.cu"), *build.CSRC.glob("*.cuh")):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    assert (tmp_path / "sm90.cuh").exists()
    before = build.digest(tmp_path)
    assert build.digest(tmp_path) == before
    header = tmp_path / "sm90.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    assert build.digest(tmp_path) != before
    assert all(p.suffix == ".cu" for p in build.sources())


def test_phase_profile_builds_a_library_of_its_own():
    """The phase profile's build (the counters behind its define in the
    source) is cached under another key than the library's, so neither
    replaces the other (the build itself needs nvcc and a card)."""
    flags = (*build.NVCC_FLAGS, *profile.PROFILE_DEFINES)
    assert build.digest(flags=flags) != build.digest()
    define = profile.PROFILE_DEFINES[0].removeprefix("-D")
    assert f"#ifdef {define}" in (build.CSRC / "bottleneck.cu").read_text()


@pytest.mark.parametrize("price", [11, kernels.WEIGHT_READ_MACS, 68])
def test_bf16_plan_is_the_same_over_its_range_of_weight_prices(monkeypatch, price):
    """The weight-read price is empirical: every price from 11 to 68 picks
    the same patches at DETR-R50's four stages."""
    monkeypatch.setattr(kernels, "WEIGHT_READ_MACS", price)
    for (B, H, W, C, M, tile_h), (rows, _, tile_w) in DETR_STAGES:
        assert kernels.plan(W, M, tile_h, torch.bfloat16, C)[:2] == (rows, tile_w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_with_float64_sums(dtype):
    """The plain version with float64 sums rounds at the same points: within
    the float32 bar of the float32 sums, and of JAX's bf16 reference within
    the bf16 bar."""
    x, ws = _inputs(6, 2, 8, 6, 32, 8)
    got = _port(port.bottleneck_reference, x, ws, dtype=dtype, accumulate=torch.float64)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, _port(port.bottleneck_reference, x, ws), atol=1e-4, rtol=1e-4)
    else:
        assert _rel_err(got, _jax(ref.bottleneck_reference, x, ws, dtype=jnp.bfloat16)) <= BF16_REL


def test_bound_at_the_stage1_bench_geometry():
    """0.965 GB of x and out at 3.35 TB/s against 131 GFLOP at 989 TFLOP/s."""
    ms, by = bench.bound(16, 184, 320, 256, 64, torch.bfloat16)
    assert by == "bytes" and ms == pytest.approx(0.288, abs=1e-3)
    ms, by = bench.bound(16, 184, 320, 256, 64, torch.float32)
    assert by == "operations" and ms == pytest.approx(bench.flops(16, 184, 320, 256, 64) / 67e9)


def test_bench_drives_on_the_cpu(tmp_path):
    out = tmp_path / "bench.json"
    res = bench.main(["--device", "cpu", "--iters", "1", "--json-out", str(out)])
    assert json.loads(out.read_text()) == res
    assert res["device"] == "cpu" and list(res["shapes"]) == [s[0] for s in bench.SHAPES]
    for label, _, tiles in bench.SHAPES:
        entry = res["shapes"][label]
        for th in tiles:
            assert entry[f"cuda_th{th}_maxerr"] == 0.0 and entry[f"cuda_th{th}_launches"] == 0
            assert f"cuda_th{th}_ms" not in entry  # nothing is timed on the CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_refuses_a_tile_taller_than_the_gemm_tile(dtype):
    """float32: tile_h above the GEMM tile's rows; bf16: a ring of tile_h + 2
    rows three pixels wide that no tiles cover."""
    tallest = max(kernels.GEMM_ROWS) if dtype == torch.float32 else max(kernels.MMA_TILES) // 3 - 2
    with pytest.raises(ValueError, match="no tile"):
        kernels.plan(320, 64, tallest + 1, dtype, 256)
