"""Port attention (office_person_detection_vit_torch) against the JAX package.

The plain version is held against JAX ``attention_reference`` and against the
Pallas kernels run in interpret mode, as tests/test_attention_ops.py runs
them. Inputs are made with numpy from a seed. float32 throughout; tolerance
1e-5 absolute (sums in another order). Rows with no valid key are left out
of the Pallas comparisons: the JAX paths disagree there (ROADMAP quirk C1).
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch import attention_kernel_bench as abench
from office_person_detection_vit_torch.kernels import attention as kernels
from office_person_detection_vit_torch.kernels import build
from office_person_detection_vit_torch.ops import attention as port
from office_person_detection_vit_tpu.ops import attention as ref
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

REPO = Path(__file__).resolve().parent.parent


def _inputs(seed, B, H, Lq, Lk, D, mask_frac):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Lq, D)).astype(np.float32)
    k = rng.normal(size=(B, H, Lk, D)).astype(np.float32)
    v = rng.normal(size=(B, H, Lk, D)).astype(np.float32)
    mask = None if mask_frac is None else rng.random((B, Lk)) > mask_frac
    return q, k, v, mask


def _port(q, k, v, mask, fn=port.attention_reference):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    return fn(*t, m).numpy()


def _jax(fn, q, k, v, mask, **kw):
    m = None if mask is None else jnp.asarray(mask)
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), m, **kw))


@pytest.mark.parametrize(
    "shape,mask_frac",
    [((2, 4, 37, 53, 32), None), ((2, 4, 37, 53, 32), 0.3), ((1, 2, 100, 260, 16), 0.2),
     ((1, 2, 67, 131, 64), None), ((1, 2, 67, 131, 64), 0.3), ((1, 2, 37, 53, 48), 0.3),
     ((1, 2, 37, 53, 80), 0.3), ((1, 2, 37, 53, 128), 0.3)],
)
def test_reference_matches_jax_reference(shape, mask_frac):
    q, k, v, mask = _inputs(0, *shape, mask_frac)
    np.testing.assert_allclose(_port(q, k, v, mask), _jax(ref.attention_reference, q, k, v, mask), atol=1e-5)


@pytest.mark.parametrize("mask_frac", [None, 0.3])
@pytest.mark.parametrize("D", [32, 64, 48, 80, 128, 160])
def test_reference_matches_whole_kv_pallas(mask_frac, D):
    """The plain version (the kernels' twin, above 128 too: 160 runs the
    chunked bodies on the card) against K1 in interpret mode."""
    q, k, v, mask = _inputs(1, 2, 4, 37, 53, D, mask_frac)
    got = _port(q, k, v, mask)
    want = _jax(ref.attention_pallas, q, k, v, mask, interpret=True)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("lq,lk,D", [(64, 64, 32), (100, 1008, 32), (197, 197, 64), (67, 131, 48), (67, 131, 80),
                                     (67, 131, 128), (67, 131, 192), (67, 131, 256)])
def test_reference_matches_flash_pallas(lq, lk, D):
    q, k, v, mask = _inputs(2, 2, 2, lq, lk, D, 0.2)
    got = _port(q, k, v, mask)
    want = _jax(ref.attention_pallas_flash, q, k, v, mask, interpret=True)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_fully_masked_entry_gives_mean_of_v():
    """Quirk C1: the port follows attention_reference, mean(V) over Lk."""
    q, k, v, mask = _inputs(3, 2, 2, 5, 9, 16, 0.3)
    mask[0] = False
    got = _port(q, k, v, mask)
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(1, keepdims=True), got[0].shape), atol=1e-6)
    np.testing.assert_allclose(got, _jax(ref.attention_reference, q, k, v, mask), atol=1e-5)


def test_return_probs_match_jax():
    q, k, v, mask = _inputs(4, 1, 2, 5, 7, 8, 0.3)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out, probs = port.attention_reference(*t, torch.from_numpy(mask), return_probs=True)
    _, jprobs = ref.attention_reference(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask), return_probs=True)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("fn", [kernels.attention_whole_kv, kernels.attention_flash, port.multi_head_attention])
def test_cpu_tensors_take_the_plain_version(fn):
    q, k, v, mask = _inputs(5, 1, 2, 11, 13, 16, 0.3)
    np.testing.assert_array_equal(_port(q, k, v, mask, fn), _port(q, k, v, mask))


@pytest.mark.parametrize("fn", [kernels.attention_whole_kv, kernels.attention_flash, port.multi_head_attention])
def test_non_cuda_device_raises(fn):
    """A tensor that is not on the CPU takes the kernel path, which raises on
    anything but a CUDA tensor instead of falling back to the plain version."""
    q = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(q, q, q)


def test_load_library_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.load_library()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_library()


def test_one_library_builds_every_source():
    """Both wrappers load the library that one nvcc call builds from every
    ``csrc/*.cu``."""
    names = [p.name for p in build.sources()]
    assert names == ["attention.cu", "bottleneck.cu"]


@pytest.mark.parametrize(
    "lk,d,dtype,flash",
    [
        (920, 32, torch.bfloat16, True),  # DETR-R50 encoder/cross-attention in bf16: K2 measured faster
        (100, 32, torch.bfloat16, True),  # its decoder self-attention in bf16: K2 measured faster too
        (920, 32, torch.float32, True),  # the same in float32: 244,632 B > 227 KB
        (100, 32, torch.float32, False),  # decoder self-attention
        (3680, 32, torch.bfloat16, True),  # DETR-DC5 at 736x1280
        (84, 16, torch.float32, False),  # small tier at 224x384
        (3681, 64, torch.bfloat16, True),  # ViT-base/16 at 736x1280
        (3681, 64, torch.float32, True),  # the same in float32
        (197, 64, torch.float32, False),  # ViT-base at 224x224: K1 fits (117,445 B)
        (65, 48, torch.float32, False),  # a padded head dim takes the padded width's plan (64)
        (197, 80, torch.float32, False),  # ViT-H/14 at 224x224 (80 padded to 128): K1 fits (201,925 B)
        (3681, 128, torch.bfloat16, True),  # head dim 128 on the ViT detect's token count
        (197, 256, torch.float32, False),  # above 128 the chunked K1 fits at any Lk: float32 takes it
        (8192, 136, torch.float32, False),
        (8192, 256, torch.bfloat16, True),
    ],
)
def test_dispatch_rule(lk, d, dtype, flash):
    assert kernels.use_flash(lk, d, dtype) is flash


@pytest.mark.parametrize("d,want", [(1, 16), (16, 16), (17, 32), (32, 32), (33, 64), (48, 64), (64, 64),
                                    (65, 128), (80, 128), (128, 128), (129, 192), (136, 192), (192, 192),
                                    (193, 256), (256, 256), (300, 320)])
def test_kernel_head_dim(d, want):
    assert kernels.kernel_head_dim(d) == want
    assert kernels.is_wide(d) is (want > 128)


@pytest.mark.parametrize("d", [129, 256, 0])
def test_head_dims_off_the_kernels_raise_naming_c7(d):
    """Until C.7 closed, head dims above 128 raised; now every head dim of
    at least 1 runs: above 128 padded to a multiple of 64 for the chunked
    bodies, and only a head dim of 0 raises."""
    if not d:
        with pytest.raises(ValueError, match="at least 1"):
            kernels.kernel_head_dim(d)
        return
    q = torch.zeros(1, 1, 4, d)
    seen = []
    out = kernels.padded_call(lambda *t, scale: seen.append((t[0].shape[-1], scale)) or t[0], q, q, q)
    assert out.shape == q.shape and seen == [(kernels.kernel_head_dim(d), pytest.approx(d**-0.5))]
    assert not kernels.use_flash(197, d, torch.float32) and kernels.whole_kv_fits(4096, d, torch.float32)


def _scaled_plain(q, k, v, mask, with_lse):
    """The plain version with an explicit scale: padded_call's callee here,
    where the card's would be the kernel."""
    def call(q, k, v, scale):
        out = port.attention_reference(q, k, v, mask, scale=scale)
        return (out, port.attention_lse(q, k, mask, scale=scale)) if with_lse else out
    return call


@pytest.mark.parametrize("D", [8, 20, 48, 16, 64, 80, 128, 136, 200])
@pytest.mark.parametrize("with_lse", [False, True])
def test_padded_call_with_the_plain_version_is_the_unpadded_call(D, with_lse):
    """Zero columns up to the kernel's head dim, the true scale 1/sqrt(D)
    and the result cut back: the unpadded plain version's output and
    log-sum-exp (float32 summation order)."""
    q, k, v, mask = (torch.from_numpy(a) if a is not None else None for a in _inputs(3, 2, 3, 37, 53, D, 0.3))
    seen = []

    def callee(q, k, v, scale):
        seen.append((q.shape[-1], scale))
        return _scaled_plain(q, k, v, mask, with_lse)(q, k, v, scale)

    got = kernels.padded_call(callee, q, k, v)
    assert seen == [(kernels.kernel_head_dim(D), pytest.approx(D**-0.5, rel=1e-15))]
    want = port.attention_reference(q, k, v, mask)
    out = got[0] if with_lse else got
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6)
    if with_lse:
        np.testing.assert_allclose(got[1].numpy(), port.attention_lse(q, k, mask).numpy(), atol=1e-5)


@pytest.mark.parametrize("D", [20, 48, 80, 160])
def test_padded_call_of_the_backward_is_the_unpadded_backward(D):
    """The backward pair's padding: q, k, v, out and g padded, dq/dk/dv cut
    back; with the true scale the plain pair's gradients are unchanged."""
    q, k, v, mask = (torch.from_numpy(a) if a is not None else None for a in _inputs(4, 1, 2, 37, 53, D, 0.3))
    out, lse = port.attention_reference(q, k, v, mask), port.attention_lse(q, k, mask)
    g = torch.from_numpy(np.random.default_rng(5).normal(size=q.shape).astype(np.float32))
    got = kernels.padded_call(
        lambda q, k, v, out, g, scale: port.attention_backward_reference(q, k, v, mask, out, lse, g, scale=scale),
        q, k, v, out, g)
    want = port.attention_backward_reference(q, k, v, mask, out, lse, g)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_whole_kv_smem_arithmetic():
    assert kernels.whole_kv_smem_bytes(920, 32, torch.bfloat16) == 126_720  # 960 keys: 15 tiles of 64
    assert kernels.whole_kv_smem_bytes(100, 32, torch.bfloat16) == 16_896  # 128 keys
    assert kernels.whole_kv_smem_bytes(920, 32, torch.float32) == 244_632
    assert kernels.whole_kv_smem_bytes(197, 64, torch.float32) == 117_445  # ViT-base at 224x224
    assert kernels.whole_kv_smem_bytes(197, 48, torch.float32) == 117_445  # padded to 64
    assert kernels.whole_kv_smem_bytes(197, 80, torch.float32) == 201_925  # ViT-H: padded to 128, no query tile
    assert kernels.whole_kv_smem_bytes(197, 128, torch.bfloat16) == 132_096  # 256 keys
    # above 128 the chunked body stages 64-key tiles whatever Lk (3 tiles of 64 x 65 floats, one of 64 x 129, a
    # byte a key)
    assert kernels.whole_kv_smem_bytes(4096, 256, torch.float32) == (3 * 64 * 65 + 64 * 129) * 4 + 64 == 83_008


@pytest.mark.parametrize(
    "lk,d,dtype,fits",
    [(920, 32, torch.bfloat16, True), (1728, 32, torch.bfloat16, True), (1729, 32, torch.bfloat16, False),
     (920, 32, torch.float32, False), (84, 16, torch.float32, True), (3680, 32, torch.bfloat16, False),
     (421, 64, torch.float32, True), (422, 64, torch.float32, False), (832, 64, torch.bfloat16, True),
     (833, 64, torch.bfloat16, False), (421, 40, torch.float32, True), (422, 33, torch.float32, False),
     (226, 128, torch.float32, True), (227, 80, torch.float32, False), (448, 128, torch.bfloat16, True),
     (449, 100, torch.bfloat16, False)],
)
def test_whole_kv_fits(lk, d, dtype, fits):
    """K1 takes K/V that fit a block's 227 KB; it raises beyond (K2 is there)."""
    assert kernels.whole_kv_fits(lk, d, dtype) is fits


@pytest.mark.parametrize(
    "lq,lk,d,dtype,blocks,threads",
    [
        (920, 920, 32, torch.bfloat16, 4, 480),  # R50 encoder: 58 warp tiles, 4 blocks of 15 warps
        (100, 920, 32, torch.bfloat16, 1, 224),  # R50 cross-attention: 7 warps
        (100, 100, 32, torch.bfloat16, 1, 224),  # R50 decoder self-attention
        (256, 256, 32, torch.bfloat16, 1, 512),  # 16 warps, the most a block takes
        (257, 256, 32, torch.bfloat16, 2, 288),  # 17 warp tiles: 2 blocks of 9 warps
        (1, 1, 16, torch.bfloat16, 1, 32),
        (84, 84, 16, torch.float32, 2, 256),  # DETR-small (float32): 64-row blocks
        (256, 256, 128, torch.bfloat16, 2, 256),  # head dim 128: at most 8 warps a block
        (197, 197, 80, torch.bfloat16, 2, 224),  # ViT-H (80 padded to 128): 13 warp tiles, 2 blocks of 7
    ],
)
def test_whole_kv_plan(lq, lk, d, dtype, blocks, threads):
    plan = kernels.whole_kv_plan(lq, lk, d, dtype)
    assert plan == {"blocks_per_head": blocks, "threads": threads,
                    "smem_bytes": kernels.whole_kv_smem_bytes(lk, d, dtype)}
    if dtype == torch.bfloat16:  # every query row has a warp; no block is idle
        rows = blocks * threads // 32 * kernels.WARP_ROWS
        assert rows >= lq and rows - lq < blocks * kernels.WARP_ROWS
        assert threads <= 32 * kernels.whole_kv_max_warps(d)


#: Every kernel instantiation the source names in its attributes table.
_COMPILED = set(__import__("re").findall(r'\{"(attention_[^"]+)", \(const void\*\)',
                                         (build.CSRC / "attention.cu").read_text()))


@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 100, 128, 136, 192, 256, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hopper_bodies_take_bf16_at_64_and_128(d, dtype):
    """is_wgmma (which labels the bench's rows) holds for bf16 at head dims
    64, 128, 192 and 256 and those padded to them (136 to 192), and there
    the source compiles K2 and the pair as Hopper bodies (K2 and both
    kernels of the pair, in its attributes table; K2 and the dQ kernel as
    the in-line bodies above 128, ``*_wgmma_inline``) and no mma.sync body
    of K2 or the pair is left; above 256 (320) bf16 stays on the chunked
    bodies."""
    hopper = dtype == torch.bfloat16 and 32 < d <= 256
    assert kernels.is_wgmma(d, dtype) is hopper
    if hopper:
        kd = kernels.kernel_head_dim(d)
        inline = "_inline" if kd > 128 else ""
        assert {f"attention_flash_wgmma{inline}<bf16,{kd}>", f"attention_bwd_dq_wgmma{inline}<bf16,{kd}>",
                f"attention_bwd_dkdv_wgmma<bf16,{kd}>"} <= _COMPILED
    assert not any(n.startswith(("attention_flash_mma", "attention_bwd_dq_mma", "attention_bwd_dkdv_mma"))
                   and n.endswith((",64>", ",128>")) for n in _COMPILED)


def test_chip_smoke_counts_wgmma_apart_from_mma():
    """chip_smoke.py's SASS reading: HGMMA (wgmma) and UTMALDG (TMA loads)
    are counted apart from HMMA (mma.sync), and each attributes name finds
    its one function (the Hopper body's name is no prefix match of the
    mma.sync one's)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sass = """
        Function : _ZN45_GLOBAL__N__45d6_12_attention_cu_c412ab1f21attention_flash_wgmmaILi64EEEv14CUtensorMap_st
        /*0a80*/                   UTMALDG.3D [UR8], [UR4], desc[UR10] ;
        /*0b80*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0c80*/                   HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8], R88 ;
        Function : _ZN45_GLOBAL__N__45d6_12_attention_cu_c412ab1f19attention_flash_mmaILi32EEEvPK13__nv_bfloat16
        /*0a80*/                   HMMA.16816.F32.BF16 R4, R12, R20, R4 ;
    """
    counts = smoke.count_ops(sass)
    assert smoke.ops_of(counts, "attention_flash_wgmma<bf16,64>") == {"HMMA": 0, "HGMMA": 2, "UTMALDG": 1}
    assert smoke.ops_of(counts, "attention_flash_mma<bf16,32>") == {"HMMA": 1, "HGMMA": 0, "UTMALDG": 0}


@pytest.mark.parametrize(
    "shape,dtype,flops,nbytes,by",
    [
        ((8, 8, 920, 920, 32), torch.bfloat16, 4 * 8 * 920 * 8 * 920 * 32, 4 * 8 * 8 * 920 * 32 * 2, "operations"),
        ((8, 8, 100, 100, 32), torch.bfloat16, 4 * 8 * 100 * 8 * 100 * 32, 4 * 8 * 8 * 100 * 32 * 2, "bytes"),
        ((1, 8, 84, 84, 16), torch.float32, 4 * 8 * 84 * 84 * 16, 4 * 8 * 84 * 16 * 4, "operations"),
    ],
    ids=["r50_encoder_bf16", "r50_decoder_self_bf16", "small_encoder_f32"],
)
def test_bench_bound(shape, dtype, flops, nbytes, by):
    """The bound: the larger of the FLOPs over the type's peak and the bytes
    of q, k, v and out over the HBM rate; a mask counts only its valid keys
    and adds its bytes."""
    t = max(flops / abench.PEAK_FLOPS[dtype], nbytes / abench.PEAK_BYTES) * 1e3
    assert abench.bound(shape, dtype, None) == (pytest.approx(t, rel=1e-12), by)
    B, Lk = shape[0], shape[3]
    mask = abench.ragged_mask(B, Lk)
    share = mask.sum().item() / (B * Lk)
    t_masked = max(flops * share / abench.PEAK_FLOPS[dtype], (nbytes + B * Lk) / abench.PEAK_BYTES) * 1e3
    assert abench.bound(shape, dtype, mask)[0] == pytest.approx(t_masked, rel=1e-12)


def test_bench_ragged_mask():
    """Entry b of B keeps its first Lk - (b + 1) Lk / 4B keys: at DETR-R50's
    B 8 and 920 keys, 892 down to 690."""
    mask = abench.ragged_mask(8, 920)
    assert mask.sum(1).tolist() == [892, 863, 834, 805, 777, 748, 719, 690]
    assert all(bool(mask[b, : n].all()) for b, n in enumerate(mask.sum(1).tolist()))


def test_bench_loads_another_checkout_beside_this_one():
    """``--against`` imports another checkout's wrappers under a name of their
    own; on the CPU they run their plain version, equal to this one's."""
    other = abench.load_kernels(REPO)
    assert other is not kernels and other.__name__.endswith(".kernels.attention")
    q, k, v, mask = abench.make_inputs((1, 2, 5, 7, 16), torch.float32, True, seed=0, device="cpu")
    for name in ("attention_whole_kv", "attention_flash"):
        assert torch.equal(getattr(other, name)(q, k, v, mask), getattr(kernels, name)(q, k, v, mask))


#: Neither JAX nor what only the JAX package's side of the repo uses (the card
#: machine has none of transformers, sklearn, matplotlib and msgpack).
_FORBIDDEN = ("jax", "flax", "ml_dtypes", "office_person_detection_vit_tpu", "transformers", "sklearn", "matplotlib",
              "msgpack")


def _port_sources():
    return sorted((REPO / "office_person_detection_vit_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _FORBIDDEN, f"{path}: imports {name}"


def test_import_guard_covers_the_training_slice():
    names = {str(p.relative_to(REPO)) for p in _port_sources()}
    pkg = "office_person_detection_vit_torch"
    want = {f"{pkg}/train_detr.py", f"{pkg}/models/layers.py"} | {
        f"{pkg}/training/{m}.py" for m in ("__init__", "augment", "criterion", "data", "matcher", "train_step")}
    assert want <= names


def test_import_guard_covers_the_tracking_slice():
    names = {str(p.relative_to(REPO)) for p in _port_sources()}
    pkg = "office_person_detection_vit_torch"
    want = {f"{pkg}/tracking/{m}.py" for m in ("__init__", "similarity", "track", "tracker", "lightweight_tracker",
                                                "reid_feature_extractor", "scan_tracker")} | {
        f"{pkg}/benchmark/__init__.py", f"{pkg}/benchmark/mot_metrics.py", f"{pkg}/ops/kalman.py",
        f"{pkg}/ops/assignment.py", f"{pkg}/utils/export_utils.py", f"{pkg}/pipeline/phases/tracking.py"}
    assert want <= names


@pytest.mark.parametrize("grad_input", [0, 1, 2])
def test_kernels_refuse_inputs_that_require_grad(grad_input):
    """The kernels' output has no grad_fn: with grad enabled and an input
    that requires grad, the launch path refuses before it launches (the CUDA
    branch cannot run here, so the check is held directly)."""
    q, k, v = (torch.zeros(1, 2, 4, 16) for _ in range(3))
    (q, k, v)[grad_input].requires_grad_(True)
    with pytest.raises(RuntimeError, match="B.4"):
        build.refuse_autograd("attention_flash", q, k, v)
    with torch.no_grad():
        build.refuse_autograd("attention_flash", q, k, v)
    with torch.inference_mode():
        build.refuse_autograd("attention_flash", q, k, v)
    build.refuse_autograd("attention_flash", q.detach(), k.detach(), v.detach(), None)


def test_import_guard_covers_the_last_modules():
    names = {str(p.relative_to(REPO)) for p in _port_sources()}
    pkg = "office_person_detection_vit_torch"
    want = {f"{pkg}/{m}.py" for m in (
        "ops/homography_fit", "calibration/reprojection_error", "calibration/camera_calibrator",
        "evaluation/transform_evaluator", "benchmark/tracking_benchmark", "benchmark/__main__",
        "visualization/dashboard_app", "visualization/dashboard_utils", "visualization/feature_visualizer",
        "core/interfaces", "core/policy", "detection/preprocessing", "models/clip", "models/weights",
        "tracking/reid_feature_extractor", "utils/export_utils")}
    assert want <= names
    # streamlit only inside dashboard_app.main(), as in JAX
    tree = ast.parse((REPO / pkg / "visualization" / "dashboard_app.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    inside = {id(n) for n in ast.walk(main)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import) and any(a.name.split(".")[0] == "streamlit" for a in node.names):
            assert id(node) in inside


def test_import_guard_covers_the_detector_slice():
    names = {str(p.relative_to(REPO)) for p in _port_sources()}
    pkg = "office_person_detection_vit_torch"
    want = {f"{pkg}/models/yolo.py", f"{pkg}/models/single_shot.py", f"{pkg}/detection/ssd_detector.py",
            f"{pkg}/detection/yolo_detector.py", f"{pkg}/ops/staging.py", f"{pkg}/ops/preprocessing.py",
            f"{pkg}/profile_detect.py"}
    assert want <= names
