"""The attention kernels K1 and K2 at the shapes DETR's paths give them, on the card.

    python -m office_person_detection_vit_torch.attention_kernel_bench \\
        [--against DIR] [--iters 20] [--json-out PATH]

For each case of :data:`CASES` it holds the kernel (``kernels/attention.py``)
against the plain version on the same inputs (:data:`TOLERANCE`, absolute)
and reports its device time (:func:`cuda_ms`), the plain version's, SDPA's
(``scaled_dot_product_attention``, the library call for the same function),
the bound and the card's name and power limit.

``--against DIR`` also times the kernels of the port checkout at ``DIR`` (an
earlier commit, unpacked with ``git archive``) on the same inputs, through
that checkout's own wrappers and library, built from its own sources into its
own ``_build/``. Each case is timed this, other, other, this in one process,
so both versions are timed by one method on one card. Needs a card: it raises
without one.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from .ops.attention import attention_reference

#: (kernel, (B, H, Lq, Lk, D), type, ragged key mask, the path that gives the
#: shape). DETR-R50 and DC5 at 736x1280 (920 and 3680 tokens, 100 queries),
#: DETR-small at 224x384 (84 tokens, 25 queries, head dim 16).
CASES = [
    ("attention_whole_kv", (8, 8, 920, 920, 32), "bfloat16", True, "R50 encoder, beside K2"),
    ("attention_whole_kv", (8, 8, 100, 920, 32), "bfloat16", True, "R50 cross, beside K2"),
    ("attention_whole_kv", (8, 8, 100, 100, 32), "bfloat16", False, "R50 decoder self, beside K2"),
    ("attention_flash", (2, 8, 3680, 3680, 32), "bfloat16", True, "DC5 encoder"),
    ("attention_flash", (2, 8, 100, 3680, 32), "bfloat16", True, "DC5 cross"),
    ("attention_flash", (8, 8, 920, 920, 32), "bfloat16", True, "R50 encoder (main path)"),
    ("attention_flash", (8, 8, 100, 920, 32), "bfloat16", True, "R50 cross (main path)"),
    ("attention_flash", (8, 8, 100, 100, 32), "bfloat16", False, "R50 decoder self (main path)"),
    ("attention_flash", (8, 8, 920, 920, 32), "float32", True, "float32 encoder, B 8"),
    ("attention_flash", (2, 8, 100, 920, 32), "float32", True, "float32 R50 cross"),
    ("attention_whole_kv", (2, 8, 100, 100, 32), "float32", False, "float32 R50 decoder self"),
    ("attention_whole_kv", (1, 8, 84, 84, 16), "float32", True, "DETR-small encoder"),
    ("attention_whole_kv", (1, 8, 25, 84, 16), "float32", True, "DETR-small cross"),
    ("attention_whole_kv", (1, 8, 25, 25, 16), "float32", False, "DETR-small decoder self"),
]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: Kernel against the plain version in float32 on the same input values.
#: float32: summation order only. bf16: the kernels round the probabilities
#: and the output to bf16 (relative 2^-8 each) on outputs of size ~1.
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
#: The instruction that does the products, by type.
INSTRUCTION = {torch.bfloat16: "mma.sync.m16n8k16", torch.float32: "FFMA (CUDA cores)"}
# Published H100 SXM peaks (dense): HBM bytes/s; bf16 tensor-core and
# non-tensor float32 FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

_cycles_per_ms: float | None = None


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


def bound(shape, dtype: torch.dtype, mask) -> tuple[float, str]:
    """(least ms on an H100, "bytes" or "operations"): q, k, v read and out
    written once, the mask bytes read once; QK^T and P.V over the valid keys
    of this mask."""
    B, H, Lq, Lk, D = shape
    item = torch.empty((), dtype=dtype).element_size()
    valid_keys = Lk * B if mask is None else int(mask.sum().item())
    flops = 4.0 * H * Lq * valid_keys * D
    nbytes = (2 * B * H * Lq * D + 2 * B * H * Lk * D) * item + (0 if mask is None else B * Lk)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
    fn = getattr(kernels, name)
    q, k, v, mask = make_inputs(shape, dtype, masked, seed)
    err = max_error(fn, q, k, v, mask)
    sdpa_mask = None if mask is None else mask[:, None, None, :]
    bound_ms, bound_by = bound(shape, dtype, mask)
    return {
        "name": name, "shape": list(shape), "dtype": dt, "masked": masked, "path": path,
        "max_abs_err": err, "tolerance": TOLERANCE[dtype],
        "ms": cuda_ms(lambda: fn(q, k, v, mask), iters),
        "plain_ms": cuda_ms(lambda: attention_reference(q, k, v, mask), 5),
        "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask), iters),
        "bound_ms": bound_ms, "bound_by": bound_by, "instruction": INSTRUCTION[dtype],
    }


def describe(row: dict) -> str:
    """One line of a measured case."""
    return (f"{row['name']:19s} {str(tuple(row['shape'])):26s} {row['dtype']:8s} {row['instruction']:18s} "
            f"err {row['max_abs_err']:.2e} (tol {row['tolerance']:.0e}) ms {row['ms']:.4f} "
            f"plain {row['plain_ms']:.4f} sdpa {row['library_ms']:.4f} bound {row['bound_ms']:.4f} "
            f"({row['bound_by']}, {100 * row['bound_ms'] / row['ms']:.1f}% of it)")


def load_kernels(root: Path, module: str = "attention"):
    """``kernels/<module>.py`` of the port checkout at ``root``, imported as
    a package of its own name, so that it and this checkout's can be loaded
    side by side."""
    pkg_dir = (Path(root) / "office_person_detection_vit_torch").resolve()
    alias = f"_port_{abs(hash(str(pkg_dir))):x}"
    if alias not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            alias, pkg_dir / "__init__.py", submodule_search_locations=[str(pkg_dir)])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[alias] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(f"{alias}.kernels.{module}")


def main(argv=None) -> dict:
    """Measure every case; print one line per case; return (and with
    ``--json-out`` write) the results."""
    from .bottleneck_kernel_bench import card
    from .kernels import attention as kernels

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--against", type=Path, help="a port checkout whose kernels are timed beside these")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--json-out", type=Path)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the attention bench times the CUDA kernels and needs a card")

    smi = card()
    print(f"device: {smi}", flush=True)
    other = load_kernels(args.against) if args.against else None
    rows = []
    for seed, case in enumerate(CASES):
        row = measure(kernels, case, seed, args.iters)
        if other is not None:
            name, shape, dt, masked, _ = case
            q, k, v, mask = make_inputs(shape, DTYPES[dt], masked, seed)
            mine, theirs = getattr(kernels, name), getattr(other, name)
            row["against_max_abs_err"] = max_error(theirs, q, k, v, mask)
            t = [cuda_ms(lambda f=f: f(q, k, v, mask), args.iters) for f in (mine, theirs, theirs, mine)]
            row.update(ms_abba=[t[0], t[3]], against_ms_abba=[t[1], t[2]],
                       ms=(t[0] + t[3]) / 2, against_ms=(t[1] + t[2]) / 2)
        line = describe(row)
        if other is not None:
            line += (f" | against {row['against_ms']:.4f} ms (err {row['against_max_abs_err']:.2e}; "
                     f"readings {row['against_ms_abba'][0]:.4f} {row['against_ms_abba'][1]:.4f}, "
                     f"this {row['ms_abba'][0]:.4f} {row['ms_abba'][1]:.4f}) -> {row['against_ms'] / row['ms']:.2f}x")
        print(line, flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    results = {"device": smi, "iters": args.iters, "against": str(args.against) if args.against else None,
               "cases": rows}
    if args.json_out:
        args.json_out.parent.mkdir(parents=True, exist_ok=True)
        args.json_out.write_text(json.dumps(results, indent=1))
        print(f"wrote {args.json_out}", flush=True)
    return results


if __name__ == "__main__":
    main()
