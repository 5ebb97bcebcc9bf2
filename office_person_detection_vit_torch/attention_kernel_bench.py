"""The attention kernels K1 and K2 at the shapes DETR's paths give them, on the card.

    python -m office_person_detection_vit_torch.attention_kernel_bench \\
        [--against DIR] [--define NAME=VALUE ...] [--iters 20] [--ladder] [--only REGEX] [--reverse]
        [--json-out PATH]

For each case of :data:`CASES` and :data:`VIT_CASES` it holds the kernel (``kernels/attention.py``)
against the plain version on the same inputs (:data:`TOLERANCE`, absolute)
and reports its device time (:func:`cuda_ms`), the plain version's, SDPA's
(``scaled_dot_product_attention``, the library call for the same function),
the bound and beside it the exponentials' least time at the card's maximum
SM clock (:func:`exp_ms`), the
host's microseconds a wrapper call (:func:`host_us`) and the card's name and
power limit; the :data:`PADDED_64` row runs the head-dim-64 body on DETR-R50's
encoder input zero-padded to 64. Then B.4's backward pair at each of
:data:`BACKWARD_CASES` against the pair's plain version (:data:`B4_BAR`),
beside the plain version's time, SDPA's backward and the pair's bound.
``--ladder`` then times float32 K1 beside K2 (K1, K2, K2, K1) at every head
dim and :data:`LADDER_LENGTHS` (:func:`ladder`), the reading ``use_flash``'s
float32 cut comes from.

``--against DIR`` also times the kernels of the port checkout at ``DIR`` (an
earlier commit, unpacked with ``git archive``) on the same inputs, through
that checkout's own wrappers and library, built from its own sources into its
own ``_build/``. Each case is timed this, other, other, this in one process
(``--reverse``: other, this, this, other), so both versions are timed by one
method on one card (the pair on the same out, lse and g, from this
checkout's forward), and so is the host's time a call. ``--only REGEX``
keeps the cases whose shape and type (``"(8, 4, 4033, 4033, 256)
bfloat16"``) match, each on the inputs it has in the whole run. ``--define`` (repeatable) builds that checkout's library (this
checkout's, where no ``--against`` is given) with that ``nvcc`` define, so
that a variant of the source is timed against the default in the same way:
for example ``--define WGMMA_INLINE_ABOVE=0`` runs K2 and the dQ kernel at
head dims 64 and 128 on the bodies that head dims 192 and 256 run. Needs a
card: it raises without one.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from .ops.attention import attention_reference

#: The D-64 Hopper K2 on an input zero-padded to head dim 64 (with the true
#: scale; the padding is done before the timed calls), the route the narrow
#: bodies at D 16 and 32 must beat.
PADDED_64 = "attention_flash_padded_64"
#: (kernel, (B, H, Lq, Lk, D), type, ragged key mask, the path that gives the
#: shape). DETR-R50 and DC5 at 736x1280 (920 and 3680 tokens, 100 queries),
#: DETR-small at 224x384 (84 tokens, 25 queries, head dim 16). The float32
#: K1 rows at head dims 16 and 32 are the bench's only: every float32 call up
#: to head dim 128 goes to K2 (use_flash).
CASES = [
    ("attention_whole_kv", (8, 8, 920, 920, 32), "bfloat16", True, "R50 encoder, beside K2"),
    ("attention_whole_kv", (8, 8, 100, 920, 32), "bfloat16", True, "R50 cross, beside K2"),
    ("attention_whole_kv", (8, 8, 100, 100, 32), "bfloat16", False, "R50 decoder self, beside K2"),
    ("attention_flash", (2, 8, 3680, 3680, 32), "bfloat16", True, "DC5 encoder"),
    ("attention_flash", (2, 8, 100, 3680, 32), "bfloat16", True, "DC5 cross"),
    ("attention_flash", (8, 8, 920, 920, 32), "bfloat16", True, "R50 encoder (main path)"),
    (PADDED_64, (8, 8, 920, 920, 32), "bfloat16", True, "R50 encoder on the D-64 body, input zero-padded to 64"),
    ("attention_flash", (8, 8, 100, 920, 32), "bfloat16", True, "R50 cross (main path)"),
    ("attention_flash", (8, 8, 100, 100, 32), "bfloat16", False, "R50 decoder self (main path)"),
    ("attention_flash", (1, 8, 84, 84, 16), "bfloat16", True, "head dim 16 in bf16 (DETR-small's encoder shape)"),
    ("attention_flash", (8, 8, 920, 920, 32), "float32", True, "float32 encoder, B 8"),
    ("attention_flash", (2, 8, 100, 920, 32), "float32", True, "float32 R50 cross"),
    ("attention_whole_kv", (2, 8, 100, 100, 32), "float32", False, "float32 R50 decoder self, K1 (no path caller, B.S5)"),
    ("attention_whole_kv", (1, 8, 84, 84, 16), "float32", True, "DETR-small encoder, K1 (no path caller, B.S5)"),
    ("attention_flash", (1, 8, 84, 84, 16), "float32", True, "DETR-small encoder"),
    ("attention_whole_kv", (1, 8, 25, 84, 16), "float32", True, "DETR-small cross, K1 (no path caller, B.S5)"),
    ("attention_whole_kv", (1, 8, 25, 25, 16), "float32", False, "DETR-small decoder self, K1 (no path caller, B.S5)"),
    ("attention_flash", (2, 8, 100, 100, 32), "float32", False, "float32 R50 decoder self"),
    ("attention_flash", (1, 8, 25, 84, 16), "float32", True, "DETR-small cross"),
    ("attention_flash", (1, 8, 25, 25, 16), "float32", False, "DETR-small decoder self"),
]
#: The ViT paths' shapes (head dims 64 and 128, 80 padded to 128, and the
#: VITW DETR's 256, 192 and 136 padded to 192): the Hopper bodies; then the
#: panel bodies above head dim 128 (K1 in both types at the VITW DETR's
#: 224x224 tokens, float32 K2 and bf16 K2 above 256 at 1008 tokens).
#: ``chip_smoke.py`` times them in [12a], [13a] and [14a], not in [2].
VIT_CASES = [
    ("attention_flash", (8, 12, 3681, 3681, 64), "bfloat16", False, "ViT-base/16 detect at 736x1280 (main path)"),
    ("attention_flash", (8, 8, 3681, 3681, 128), "bfloat16", False, "head dim 128 on the ViT detect's tokens"),
    ("attention_flash", (8, 16, 3681, 3681, 80), "bfloat16", False, "ViT-H/16's heads (80, padded to 128)"),
    ("attention_flash", (8, 4, 3681, 3681, 256), "bfloat16", False, "the VITW DETR's detect (heads of 256)"),
    ("attention_flash", (8, 4, 1008, 1008, 192), "bfloat16", False, "heads of 192 at 1008 tokens"),
    ("attention_flash", (2, 4, 300, 260, 136), "bfloat16", True, "head dim 136, padded to 192"),
    ("attention_whole_kv", (8, 4, 197, 197, 256), "float32", False, "the VITW DETR's float32 forward (K1, main path)"),
    ("attention_whole_kv", (8, 4, 197, 197, 256), "bfloat16", False, "heads of 256 at 224x224, bf16 K1"),
    ("attention_whole_kv", (8, 4, 197, 197, 192), "float32", False, "heads of 192 at 224x224 (K1)"),
    ("attention_whole_kv", (8, 4, 197, 197, 192), "bfloat16", False, "heads of 192 at 224x224, bf16 K1"),
    ("attention_whole_kv", (2, 4, 300, 260, 136), "float32", True, "head dim 136, padded to 192 (K1)"),
    ("attention_whole_kv", (2, 4, 300, 260, 136), "bfloat16", True, "head dim 136, padded to 192, bf16 K1"),
    ("attention_flash", (8, 4, 1008, 1008, 256), "float32", True, "heads of 256 at 1008 tokens, float32 K2"),
    ("attention_flash", (8, 4, 1008, 1008, 192), "float32", True, "heads of 192 at 1008 tokens, float32 K2"),
    ("attention_flash", (8, 4, 1008, 1008, 320), "bfloat16", True, "heads of 320 at 1008 tokens (two panels)"),
    ("attention_flash", (8, 4, 1008, 1008, 384), "bfloat16", True, "heads of 384 at 1008 tokens (two panels)"),
    ("attention_whole_kv", (8, 16, 197, 197, 80), "float32", False, "ViT-H/16 at 224x224, float32 K1 (80 padded to 128)"),
    ("attention_whole_kv", (8, 12, 197, 197, 64), "float32", False, "ViT-base/16 at 224x224, float32 K1"),
    ("attention_whole_kv", (64, 12, 50, 50, 64), "float32", False, "CLIP ViT-B/32 Re-ID, 64 crops, float32 K1"),
    ("attention_whole_kv", (8, 8, 197, 197, 128), "float32", False, "head dim 128 at 224x224, float32 K1"),
    ("attention_flash", (1, 12, 3681, 3681, 64), "float32", False, "ViT-base/16 detect at 736x1280, float32, batch 1"),
    ("attention_flash", (1, 8, 3681, 3681, 128), "float32", True, "head dim 128 on the ViT detect's tokens, float32"),
]
#: B.4's backward pair: ((B, H, Lq, Lk, D), type, the path that gives the
#: shape). ViT-base/16 training at 768x1344 (4033 tokens), head dim 128 at
#: DETR-R50's training tokens (1008), ViT-H/16's heads at 4033 tokens, the
#: VITW DETR's training (heads of 256 at 4033 tokens) and heads of 192.
BACKWARD_CASES = [
    ((8, 12, 4033, 4033, 64), "bfloat16", "ViT-base/16 training at 768x1344, batch 8"),
    ((8, 8, 1008, 1008, 128), "bfloat16", "head dim 128 at DETR-R50's training tokens"),
    ((8, 16, 4033, 4033, 80), "bfloat16", "ViT-H/16's heads training (80, padded to 128)"),
    ((8, 8, 1008, 1008, 32), "bfloat16", "DETR-R50 training encoder (the narrow wgmma pair)"),
    ((8, 8, 100, 1008, 32), "bfloat16", "DETR-R50 training cross-attention (100 queries)"),
    ((8, 8, 100, 100, 32), "bfloat16", "DETR-R50 training decoder self-attention"),
    ((8, 4, 4033, 4033, 256), "bfloat16", "the VITW DETR's training at 768x1344, batch 8"),
    ((1, 4, 1008, 1008, 192), "bfloat16", "heads of 192 at 1008 tokens"),
    ((2, 4, 197, 197, 256), "float32", "heads of 256 at 224x224, float32 (the VITW DETR's float32 gradients)"),
    ((1, 4, 1008, 1008, 256), "float32", "heads of 256 at 1008 tokens, float32"),
    ((2, 4, 300, 260, 136), "float32", "head dim 136, padded to 192, float32"),
    ((1, 4, 1008, 1008, 320), "bfloat16", "heads of 320 at 1008 tokens (the bf16 pair on column panels)"),
    ((1, 4, 1008, 1008, 384), "bfloat16", "heads of 384 at 1008 tokens (the bf16 pair on column panels)"),
    ((8, 4, 1008, 1008, 320), "bfloat16", "heads of 320 at 1008 tokens, batch 8 (the card full)"),
    ((1, 8, 84, 84, 16), "float32", "DETR-small encoder at 224x384 (the float32 pair, [10a]'s shape)"),
    ((2, 8, 196, 196, 32), "float32", "the ViT DETRs' float32 gradients at 224x224, DETR's encoder"),
    ((2, 8, 197, 197, 128), "float32", "head dim 128 at 224x224, float32 ([13a]'s shape)"),
    ((2, 12, 1008, 1008, 64), "float32", "head dim 64 at 1008 tokens, float32 (384 dQ blocks)"),
    ((8, 8, 1008, 1008, 32), "float32", "DETR-R50 training encoder at 768x1344, float32"),
]
#: float32 K1 and K2 beside each other, for use_flash's cut: every head dim
#: the kernels are built for at each of these key counts (Lq = Lk), B 8 and
#: H 8 up to 920 keys and B 1 at 3681, where K1's block fits
#: (whole_kv_fits), and the two float32 K1 paths' own shapes.
LADDER_LENGTHS = (50, 84, 197, 421, 920, 3681)
LADDER_PATHS = [((64, 12, 50, 50, 64), "CLIP ViT-B/32 Re-ID, 64 crops"),
                ((1, 8, 84, 84, 16), "DETR-small encoder at 224x384")]
#: The pair against its plain version on the same values, relative
#: (relative_errors): bf16 2^-6, the rounding of P, dS and the results.
B4_BAR = {torch.bfloat16: 2.0**-6, torch.float32: 1e-5}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: Kernel against the plain version in float32 on the same input values.
#: float32: summation order only. bf16: the kernels round the probabilities
#: and the output to bf16 (relative 2^-8 each) on outputs of size ~1.
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
#: The instruction that does the products, by type.
INSTRUCTION = {torch.bfloat16: "mma.sync.m16n8k16", torch.float32: "FFMA (CUDA cores)"}
#: The Hopper bodies: bf16 K2 and the bf16 pair at every head dim, bf16 K1
#: above 128.
WGMMA_INSTRUCTION = "wgmma.m64nNk16 + TMA"
#: The register-tiled float32 bodies (4 x 4 tiles a thread): float32 K1 at
#: head dims 64 and 128, every float32 forward above 128 and the float32
#: pair above 128.
PANEL_FMA_INSTRUCTION = "FFMA (CUDA cores, 4x4 register tiles)"
#: float32 K2 and the float32 pair up to head dim 128: three TF32 products
#: a float32 product on the tensor cores (attention_flash_tf32,
#: attention_bwd_{dq,dkdv}_tf32).
TF32_INSTRUCTION = "mma.sync.m16n8k8 3xTF32"
# Published H100 SXM peaks (dense): HBM bytes/s; bf16 tensor-core and
# non-tensor float32 FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: Exponentials the SFUs issue an SM a clock. At DETR's head dims in bf16
#: these, not the products, set the floor (:func:`exp_ms`, at
#: :func:`exp_rate`).
EXP_PER_SM_CLOCK = 16
#: The float32 work rate of the 3xTF32 body: the TF32 tensor-core peak (495
#: TFLOP/s, dense) over its three products a float32 product.
TF32X3_FLOPS = 495e12 / 3

_cycles_per_ms: float | None = None
_exp_rate: float | None = None


def relative_errors(got, want) -> tuple[float, float]:
    """B.4's gradients against a reference, over tensors paired in order:
    (max |got - want| / max(1, |want|), max |got - want| / max |want|). Its
    bars hold both: the first alone is an absolute bar wherever |want| < 1,
    as every gradient is at DETR-R50's training encoder."""
    pairs = [((a.double() - b.double()).abs(), b.double().abs()) for a, b in zip(got, want)]
    return (max((err / ref.clamp(min=1.0)).max().item() for err, ref in pairs),
            max((err.max() / ref.max().clamp(min=1e-30)).item() for err, ref in pairs))


def ragged_mask(B: int, Lk: int) -> torch.Tensor:
    """Key padding as a letterboxed batch gives it: entry b keeps its first
    Lk - (b + 1) Lk / 4B keys (True = valid)."""
    mask = torch.ones(B, Lk, dtype=torch.bool)
    for b in range(B):
        mask[b, Lk - ((b + 1) * Lk) // (4 * B):] = False
    return mask


def make_inputs(shape, dtype: torch.dtype, masked: bool, seed: int, device="cuda"):
    """q, k, v ~ N(0, 1) from a seeded generator, in ``dtype`` on
    ``device``, and the ragged mask or None."""
    B, H, Lq, Lk, D = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, D, generator=g).to(device, dtype) for L in (Lq, Lk, Lk))
    return q, k, v, ragged_mask(B, Lk).to(device) if masked else None


def bound(shape, dtype: torch.dtype, mask, flops_rate: float | None = None) -> tuple[float, str]:
    """(least ms on an H100, "bytes" or "operations"): q, k, v read and out
    written once, the mask bytes read once; QK^T and P.V over the valid keys
    of this mask, at ``flops_rate`` (by default the type's peak,
    :data:`PEAK_FLOPS`; the 3xTF32 body's :data:`TF32X3_FLOPS`)."""
    B, H, Lq, Lk, D = shape
    item = torch.empty((), dtype=dtype).element_size()
    valid_keys = Lk * B if mask is None else int(mask.sum().item())
    flops = 4.0 * H * Lq * valid_keys * D
    nbytes = (2 * B * H * Lq * D + 2 * B * H * Lk * D) * item + (0 if mask is None else B * Lk)
    t_ops, t_bytes = flops / (flops_rate or PEAK_FLOPS[dtype]) * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def exp_rate() -> float:
    """The card's exponentials a second at its peak: :data:`EXP_PER_SM_CLOCK`
    on each of its SMs at its maximum SM clock (nvidia-smi's
    ``clocks.max.sm``), read once."""
    global _exp_rate
    if _exp_rate is None:
        mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True).stdout.split()[0]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _exp_rate = EXP_PER_SM_CLOCK * sms * float(mhz) * 1e6
    return _exp_rate


def exp_ms(shape, mask, per_score: int = 1, rate: float | None = None) -> float:
    """Least ms of the exponentials of a call at ``rate`` a second (by
    default the card's, :func:`exp_rate`): ``per_score`` (K2 one, the
    backward pair two: P in both kernels) for each query and valid key."""
    B, H, Lq, Lk, _ = shape
    valid = Lk * B if mask is None else int(mask.sum().item())
    return per_score * H * Lq * valid / (rate or exp_rate()) * 1e3


def b4_bound(shape, dtype, mask, backward_only: bool = False, flops_rate: float | None = None) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of B.4's forward and backward:
    q, k, v, the mask and dO read once, O, dQ, dK, dV written once; the
    products of the forward (QK^T, P.V) and of the backward (QK^T again,
    dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q) over this mask's valid
    keys: 14 H Lq D flops a valid key. ``backward_only``: the backward pair's
    own work, q, k, v, O, dO, the mask and the log-sum-exp read once, dQ, dK,
    dV written once, and its five products: 10 H Lq D flops a valid key.
    ``flops_rate``: by default the type's peak (:data:`PEAK_FLOPS`); the
    3xTF32 bodies' :data:`TF32X3_FLOPS` (:func:`pair_rate`)."""
    B, H, Lq, Lk, D = shape
    item = torch.empty((), dtype=dtype).element_size()
    valid = Lk * B if mask is None else int(mask.sum().item())
    flops = (10.0 if backward_only else 14.0) * H * Lq * valid * D
    nbytes = 4 * B * H * (Lq + Lk) * D * item + (0 if mask is None else B * Lk)
    if backward_only:
        nbytes = (3 * Lq + 2 * Lk + Lq + 2 * Lk) * B * H * D * item + 4 * B * H * Lq + (0 if mask is None else B * Lk)
    t_ops, t_bytes = flops / (flops_rate or PEAK_FLOPS[dtype]) * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pair_rate(kernels, head_dim: int, dtype: torch.dtype) -> float | None:
    """The work rate of the backward pair at ``head_dim`` for b4_bound:
    :data:`TF32X3_FLOPS` where it runs the 3xTF32 bodies
    (``kernels.is_tf32_pair``), else None (the type's peak)."""
    return TF32X3_FLOPS if kernels.is_tf32_pair(head_dim, dtype) else None


def _sleep_cycles_per_ms() -> float:
    """The card's clock as ``torch.cuda._sleep`` counts it, measured once."""
    global _cycles_per_ms
    if _cycles_per_ms is None:
        torch.cuda._sleep(1_000_000)  # wake the clock up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        torch.cuda.synchronize()
        _cycles_per_ms = 20_000_000 / start.elapsed_time(end)
    return _cycles_per_ms


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms of one fn() call: the mean over ``iters`` calls between two
    CUDA events.

    The timed calls are queued behind a sleep kernel that lasts twice as long
    as the host took to queue the same calls once before, so the device runs
    them back to back and the host's own cost per call (a Python wrapper
    takes tens of microseconds) stays outside the window.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_ms * _sleep_cycles_per_ms()))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 5, rounds: int = 3) -> float:
    """The host's microseconds of one fn() call: the median over ``rounds``
    of ``iters`` calls queued back to back on the host clock, each round
    started on an idle device and not waiting for it (the calls run on the
    device behind them)."""
    fn()
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        per_call.append((time.perf_counter() - t) * 1e6 / iters)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def max_error(fn, q, k, v, mask) -> float:
    """max |fn - plain version in float32 on the same values|; raises on a
    non-finite output or an error above the tolerance."""
    out = fn(q, k, v, mask)
    want = attention_reference(q.float(), k.float(), v.float(), mask)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{fn.__name__} {tuple(q.shape)}: non-finite output")
    err = (out.float() - want).abs().max().item()
    tol = TOLERANCE[q.dtype]
    if err > tol:
        raise AssertionError(f"{fn.__name__} {tuple(q.shape)} {q.dtype}: max|err| {err:.3e} > {tol:.0e}")
    return err


def measure(kernels, case, seed: int, iters: int = 20) -> dict:
    """One case of :data:`CASES` through the wrappers module ``kernels``:
    error, times and bound."""
    name, shape, dt, masked, path = case
    dtype = DTYPES[dt]
    q, k, v, mask = make_inputs(shape, dtype, masked, seed)
    fn = wrapper(kernels, name, q, k, v)
    err = max_error(fn, q, k, v, mask)
    sdpa_mask = None if mask is None else mask[:, None, None, :]
    tf32 = kernels.is_tf32_forward(shape[4], dtype, flash=name == "attention_flash")
    bound_ms, bound_by = bound(shape, dtype, mask, TF32X3_FLOPS if tf32 else None)
    return {
        "name": name, "shape": list(shape), "dtype": dt, "masked": masked, "path": path,
        "max_abs_err": err, "tolerance": TOLERANCE[dtype],
        "ms": cuda_ms(lambda: fn(q, k, v, mask), iters),
        "host_us": host_us(lambda: fn(q, k, v, mask)),
        "plain_ms": cuda_ms(lambda: attention_reference(q, k, v, mask), 5),
        "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask), iters),
        "bound_ms": bound_ms, "bound_by": bound_by, "exp_ms": exp_ms(shape, mask),
        "instruction": instruction(kernels, "attention_flash" if name == PADDED_64 else name,
                                   64 if name == PADDED_64 else shape[4], dtype),
    }


def wrapper(kernels, name: str, q, k, v):
    """The wrapper of a case: ``kernels.<name>``, or for :data:`PADDED_64`
    K2 at head dim 64 on q, k, v zero-padded to it once, here (the true
    scale; the result cut back to the true head dim)."""
    if name != PADDED_64:
        return getattr(kernels, name)
    d = q.shape[-1]
    padded = [torch.nn.functional.pad(t, (0, 64 - d)) for t in (q, k, v)]

    def attention_flash_padded_64(q, k, v, mask):
        return kernels._launch("attention_flash", *padded, mask, False, 1.0 / d**0.5)[..., :d]

    return attention_flash_padded_64


def instruction(kernels, name: str, head_dim: int, dtype: torch.dtype) -> str:
    """The instruction of the body that wrapper ``name`` runs at ``head_dim``
    in ``dtype``."""
    wide = kernels.is_wide(head_dim)
    if name == "attention_backward":
        if kernels.is_wgmma_pair(head_dim, dtype):
            return WGMMA_INSTRUCTION
        if kernels.is_tf32_pair(head_dim, dtype):
            return TF32_INSTRUCTION
        return PANEL_FMA_INSTRUCTION if wide else INSTRUCTION[dtype]
    if kernels.is_wgmma_forward(head_dim, dtype, flash=name == "attention_flash"):
        return WGMMA_INSTRUCTION
    if kernels.is_tf32_forward(head_dim, dtype, flash=name == "attention_flash"):
        return TF32_INSTRUCTION
    k1_tiled = name == "attention_whole_kv" and dtype == torch.float32 and kernels.kernel_head_dim(head_dim) >= 64
    return PANEL_FMA_INSTRUCTION if wide or k1_tiled else INSTRUCTION[dtype]


def library_kernels(fn, top: int = 3, calls: int = 5) -> list:
    """The CUDA kernels of ``calls`` fn() calls with the most device time, read
    with ``torch.profiler`` after two warm-up calls: [(name, device us a
    call)]; empty where the profiler saw no kernel (then "not measured")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    totals = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith(("Memcpy", "Memset")):
            totals[e.name[:160]] = totals.get(e.name[:160], 0.0) + e.time_range.elapsed_us() / calls
    return sorted(totals.items(), key=lambda r: -r[1])[:top]


def measure_backward(kernels, case, seed: int, other=None, iters: int = 10, reverse: bool = False) -> dict:
    """One case of :data:`BACKWARD_CASES`: the pair (``attention_backward``
    on this checkout's forward out and lse) against its plain version
    (``attention_backward_reference``) at :data:`B4_BAR`, its time and the
    host's time a call, the plain version's time, SDPA's backward and the
    bound; with ``other`` (another checkout's wrappers) that checkout's pair
    too, this, other, other, this (``reverse``: other, this, this, other)."""
    from .ops.attention import attention_backward_reference

    shape, dt, path = case
    dtype = DTYPES[dt]
    q, k, v, _ = make_inputs(shape, dtype, False, seed)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(seed + 1)).to("cuda", dtype)
    out, lse = kernels.attention_flash(q, k, v, None, with_lse=True)
    twin = attention_backward_reference(q, k, v, None, out, lse, g)
    fns = {"this": kernels.attention_backward}
    if other is not None:
        fns["other"] = other.attention_backward
    errs = {}
    for name, fn in fns.items():
        errs[name] = max(relative_errors(fn(q, k, v, None, out, lse, g), twin))
        if errs[name] > B4_BAR[dtype]:
            raise AssertionError(f"{name} pair {shape} {dt}: {errs[name]:.3e} from its plain version > {B4_BAR[dtype]:.2e}")
    del twin
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qq, kk, vv)
    bound_ms, bound_by = b4_bound(shape, dtype, None, True, pair_rate(kernels, shape[4], dtype))
    row = {"name": "attention_backward", "shape": list(shape), "dtype": dt, "path": path, "max_rel_err": errs["this"],
           "bar": B4_BAR[dtype], "instruction": instruction(kernels, "attention_backward", shape[4], dtype),
           "library_ms": cuda_ms(lambda: torch.autograd.grad(sdpa_out, (qq, kk, vv), g, retain_graph=True), iters),
           "plain_ms": cuda_ms(lambda: attention_backward_reference(q, k, v, None, out, lse, g), 2, 1),
           "bound_ms": bound_ms, "bound_by": bound_by, "exp_ms": exp_ms(shape, None, 2)}
    mine = lambda: kernels.attention_backward(q, k, v, None, out, lse, g)  # noqa: E731
    if other is None:
        row.update(ms=cuda_ms(mine, iters), host_us=host_us(mine))
    else:
        theirs = lambda: other.attention_backward(q, k, v, None, out, lse, g)  # noqa: E731
        row.update(abba(mine, theirs, iters, reverse), against_max_rel_err=errs["other"])
    return row


def abba(mine, theirs, iters: int, reverse: bool = False) -> dict:
    """Device ms and host microseconds a call of two versions of one
    function, timed this, other, other, this (``reverse``: other, this,
    this, other); each version's two readings in the order taken."""
    order = (theirs, mine, mine, theirs) if reverse else (mine, theirs, theirs, mine)
    t = [cuda_ms(f, iters) for f in order]
    h = [host_us(f) for f in order]
    a, b = ((1, 2), (0, 3)) if reverse else ((0, 3), (1, 2))
    return {"ms_abba": [t[i] for i in a], "against_ms_abba": [t[i] for i in b], "ms": (t[a[0]] + t[a[1]]) / 2,
            "against_ms": (t[b[0]] + t[b[1]]) / 2, "host_us": (h[a[0]] + h[a[1]]) / 2,
            "against_host_us": (h[b[0]] + h[b[1]]) / 2, "reverse": reverse}


def describe_backward(row: dict) -> str:
    """One line of a measured backward case."""
    line = (f"{row['name']:19s} {str(tuple(row['shape'])):26s} {row['dtype']:8s} {row['instruction']:18s} "
            f"err {row['max_rel_err']:.2e} (bar {row['bar']:.2e}) ms {row['ms']:.4f} host {row['host_us']:.1f} us "
            f"plain {row['plain_ms']:.4f} sdpa backward {row['library_ms']:.4f} bound {row['bound_ms']:.4f} "
            f"({row['bound_by']}, {100 * row['bound_ms'] / row['ms']:.1f}% of it) exponentials {row['exp_ms']:.4f}")
    if "against_ms" in row:
        line += against(row, row["against_max_rel_err"])
    return line


def against(row: dict, err: float) -> str:
    """The line's part for the other checkout of a row timed by abba."""
    return (f" | against {row['against_ms']:.4f} ms host {row['against_host_us']:.1f} us (err {err:.2e}; "
            f"readings {row['against_ms_abba'][0]:.4f} {row['against_ms_abba'][1]:.4f}, this {row['ms_abba'][0]:.4f} "
            f"{row['ms_abba'][1]:.4f}{'; other first' if row.get('reverse') else ''}) -> "
            f"{row['against_ms'] / row['ms']:.2f}x")


def describe(row: dict) -> str:
    """One line of a measured case."""
    return (f"{row['name']:19s} {str(tuple(row['shape'])):26s} {row['dtype']:8s} {row['instruction']:18s} "
            f"err {row['max_abs_err']:.2e} (tol {row['tolerance']:.0e}) ms {row['ms']:.4f} "
            f"host {row['host_us']:.1f} us plain {row['plain_ms']:.4f} sdpa {row['library_ms']:.4f} "
            f"bound {row['bound_ms']:.4f} ({row['bound_by']}, {100 * row['bound_ms'] / row['ms']:.1f}% of it) "
            f"exponentials {row['exp_ms']:.4f}")


def ladder_cases() -> list:
    """((B, H, L, L, D), path) of the K1/K2 ladder: LADDER_LENGTHS at every
    head dim of HEAD_DIMS, then LADDER_PATHS."""
    return [((8 if n <= 920 else 1, 8, n, n, d), f"{n} keys at head dim {d}")
            for d in (16, 32, 64, 128) for n in LADDER_LENGTHS] + LADDER_PATHS


def ladder(kernels, iters: int = 20) -> list:
    """float32 K1 and K2 beside each other at :func:`ladder_cases`, each
    held against the plain version (:data:`TOLERANCE`) and timed K1, K2, K2,
    K1 on the same inputs: K1's and K2's ms, the mean of their two readings
    (K1 "none" where its block does not fit), the readings, the faster, and
    what ``use_flash`` takes."""
    rows = []
    for seed, (shape, path) in enumerate(ladder_cases()):
        q, k, v, _ = make_inputs(shape, torch.float32, False, 700 + seed)
        row = {"shape": list(shape), "path": path, "use_flash": kernels.use_flash(shape[4], torch.float32)}
        k2_call = lambda: kernels.attention_flash(q, k, v, None)  # noqa: E731
        max_error(kernels.attention_flash, q, k, v, None)
        if kernels.whole_kv_fits(shape[3], shape[4], torch.float32):
            k1_call = lambda: kernels.attention_whole_kv(q, k, v, None)  # noqa: E731
            max_error(kernels.attention_whole_kv, q, k, v, None)
            t = [cuda_ms(f, iters) for f in (k1_call, k2_call, k2_call, k1_call)]
            row.update(attention_whole_kv=(t[0] + t[3]) / 2, attention_flash=(t[1] + t[2]) / 2,
                       whole_kv_readings=[t[0], t[3]], flash_readings=[t[1], t[2]])
        else:
            t = [cuda_ms(k2_call, iters) for _ in range(2)]
            row.update(attention_whole_kv=None, attention_flash=(t[0] + t[1]) / 2, flash_readings=t)
        k1, k2 = row["attention_whole_kv"], row["attention_flash"]
        row["faster"] = "K2" if k1 is None or k2 < k1 else "K1"
        readings = " ".join(f"{x:.4f}" for x in row.get("whole_kv_readings", []) + row["flash_readings"])
        print(f"ladder float32 {str(tuple(shape)):24s} K1 {'none' if k1 is None else f'{k1:.4f}':>8s} ms  "
              f"K2 {k2:.4f} ms (readings {readings}) -> faster {row['faster']}; use_flash takes "
              f"{'K2' if row['use_flash'] else 'K1'} [{path}]", flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def load_port_module(root: Path, name: str):
    """Module ``name`` (dotted, inside the package) of the port checkout at
    ``root``, imported under a package name of its own, so that it and this
    checkout's can be loaded side by side."""
    pkg_dir = (Path(root) / "office_person_detection_vit_torch").resolve()
    alias = f"_port_{abs(hash(str(pkg_dir))):x}"
    if alias not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            alias, pkg_dir / "__init__.py", submodule_search_locations=[str(pkg_dir)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[alias] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(f"{alias}.{name}")


def load_kernels(root: Path, module: str = "attention", defines: tuple[str, ...] = ()):
    """``kernels/<module>.py`` of the port checkout at ``root`` (see
    :func:`load_port_module`), whose library is built with the ``nvcc``
    ``defines`` added to its flags."""
    if defines:
        build = load_port_module(root, "kernels.build")
        build.NVCC_FLAGS = (*build.NVCC_FLAGS, *defines)
    return load_port_module(root, f"kernels.{module}")


def main(argv=None) -> dict:
    """Measure every case; print one line per case; return (and with
    ``--json-out`` write) the results."""
    from .bottleneck_kernel_bench import card
    from .kernels import attention as kernels

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--against", type=Path, help="a port checkout whose kernels are timed beside these")
    p.add_argument("--define", action="append", default=[], metavar="NAME=VALUE",
                   help="an nvcc define of the library timed beside this one (--against's, else this checkout's)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--ladder", action="store_true",
                   help="also time float32 K1 beside K2 at LADDER_LENGTHS x every head dim (use_flash's cut)")
    p.add_argument("--only", metavar="REGEX", help="keep the cases whose '(B, H, Lq, Lk, D) type' matches")
    p.add_argument("--reverse", action="store_true", help="time --against's version first: other, this, this, other")
    p.add_argument("--json-out", type=Path)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the attention bench times the CUDA kernels and needs a card")

    smi = card()
    print(f"device: {smi}", flush=True)
    print(f"exponentials' rate: {exp_rate():.6e} a second ({EXP_PER_SM_CLOCK} an SM a clock, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs, clocks.max.sm)", flush=True)
    root = args.against or (Path(__file__).resolve().parent.parent if args.define else None)
    other = load_kernels(root, defines=tuple(f"-D{d}" for d in args.define)) if root else None
    def wanted(shape, dt) -> bool:
        return args.only is None or re.search(args.only, f"{tuple(shape)} {dt}") is not None

    rows = []
    for seed, case in enumerate(CASES + VIT_CASES):
        if not wanted(case[1], case[2]):
            continue
        row = measure(kernels, case, seed, args.iters)
        if other is not None:
            name, shape, dt, masked, _ = case
            q, k, v, mask = make_inputs(shape, DTYPES[dt], masked, seed)
            mine, theirs = wrapper(kernels, name, q, k, v), wrapper(other, name, q, k, v)
            row["against_max_abs_err"] = max_error(theirs, q, k, v, mask)
            row.update(abba(lambda: mine(q, k, v, mask), lambda: theirs(q, k, v, mask), args.iters, args.reverse))
        line = describe(row)
        if other is not None:
            line += against(row, row["against_max_abs_err"])
        if case[2] == "float32":  # what SDPA runs in float32 there: the yardstick's own kernels
            q, k, v, mask = make_inputs(case[1], torch.float32, case[3], seed)
            sdpa_mask = None if mask is None else mask[:, None, None, :]
            row["library_kernels"] = library_kernels(
                lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask))
            line += f" | sdpa runs {row['library_kernels'] or 'not measured'}"
        print(line, flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    backward = []
    for seed, case in enumerate(BACKWARD_CASES):
        if not wanted(case[0], case[1]):
            continue
        row = measure_backward(kernels, case, 900 + seed, other, max(args.iters // 2, 5), args.reverse)
        line = describe_backward(row)
        if case[1] == "float32":
            q, k, v, _ = make_inputs(case[0], torch.float32, False, 900 + seed)
            qq, kk, vv = (t.requires_grad_(True) for t in (q, k, v))
            out = torch.nn.functional.scaled_dot_product_attention(qq, kk, vv)
            g = torch.randn_like(out)
            row["library_kernels"] = library_kernels(
                lambda: torch.autograd.grad(out, (qq, kk, vv), g, retain_graph=True))
            line += f" | sdpa backward runs {row['library_kernels'] or 'not measured'}"
        print(line, flush=True)
        backward.append(row)
        torch.cuda.empty_cache()
    results = {"device": smi, "exp_rate": exp_rate(), "iters": args.iters, "against": str(root) if root else None,
               "defines": args.define,
               "cases": rows, "backward": backward, "ladder": ladder(kernels, args.iters) if args.ladder else None}
    if args.json_out:
        args.json_out.parent.mkdir(parents=True, exist_ok=True)
        args.json_out.write_text(json.dumps(results, indent=1))
        print(f"wrote {args.json_out}", flush=True)
    return results


if __name__ == "__main__":
    main()
