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
    [((2, 4, 37, 53, 32), None), ((2, 4, 37, 53, 32), 0.3), ((1, 2, 100, 260, 16), 0.2)],
)
def test_reference_matches_jax_reference(shape, mask_frac):
    q, k, v, mask = _inputs(0, *shape, mask_frac)
    np.testing.assert_allclose(_port(q, k, v, mask), _jax(ref.attention_reference, q, k, v, mask), atol=1e-5)


@pytest.mark.parametrize("mask_frac", [None, 0.3])
def test_reference_matches_whole_kv_pallas(mask_frac):
    q, k, v, mask = _inputs(1, 2, 4, 37, 53, 32, mask_frac)
    got = _port(q, k, v, mask)
    want = _jax(ref.attention_pallas, q, k, v, mask, interpret=True)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("lq,lk", [(64, 64), (100, 1008)])
def test_reference_matches_flash_pallas(lq, lk):
    q, k, v, mask = _inputs(2, 2, 2, lq, lk, 32, 0.2)
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
    ],
)
def test_dispatch_rule(lk, d, dtype, flash):
    assert kernels.use_flash(lk, d, dtype) is flash


def test_whole_kv_smem_arithmetic():
    assert kernels.whole_kv_smem_bytes(920, 32, torch.bfloat16) == 126_720  # 960 keys: 15 tiles of 64
    assert kernels.whole_kv_smem_bytes(100, 32, torch.bfloat16) == 16_896  # 128 keys
    assert kernels.whole_kv_smem_bytes(920, 32, torch.float32) == 244_632


@pytest.mark.parametrize(
    "lk,d,dtype,fits",
    [(920, 32, torch.bfloat16, True), (1728, 32, torch.bfloat16, True), (1729, 32, torch.bfloat16, False),
     (920, 32, torch.float32, False), (84, 16, torch.float32, True), (3680, 32, torch.bfloat16, False)],
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
    ],
)
def test_whole_kv_plan(lq, lk, d, dtype, blocks, threads):
    plan = kernels.whole_kv_plan(lq, lk, d, dtype)
    assert plan == {"blocks_per_head": blocks, "threads": threads,
                    "smem_bytes": kernels.whole_kv_smem_bytes(lk, d, dtype)}
    if dtype == torch.bfloat16:  # every query row has a warp; no block is idle
        rows = blocks * threads // 32 * kernels.WARP_ROWS
        assert rows >= lq and rows - lq < blocks * kernels.WARP_ROWS
        assert threads <= 32 * kernels.WHOLE_KV_MAX_WARPS


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


_FORBIDDEN = ("jax", "flax", "ml_dtypes", "office_person_detection_vit_tpu")


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
