"""The fused bottleneck (K3) head to head with the unfused cuDNN chain, on the card.

    python -m office_person_detection_vit_torch.bottleneck_kernel_bench \\
        [--against DIR] [--json-out PATH] [--iters 16] \\
        [--dtype bfloat16|float32] [--device auto|cuda|cpu]

Counterpart of ``tools/bottleneck_kernel_bench.py`` of the JAX package, at its
stage geometries and tile sweep, and at the four stages of DETR-R50's
identity blocks at 736x1280, batch 8 (:data:`SHAPES`). Inputs are made on
the card from a seeded ``torch.Generator`` (the stage-1 x is 482 MB in bf16).
For each shape and ``tile_h`` it reports K3's time (CUDA events, mean of
``--iters`` launches after warm-up), TFLOP/s and max |err| against the plain
version on the same inputs (bf16 on the card: with float32 and with exact
sums, :func:`bf16_verdict`); the unfused cuDNN chain (three channels-last ``F.conv2d`` calls in x's type,
with bias and ReLU, and the residual) as the yardstick; the plain version's time; the bound (the larger of the bytes over
3.35 TB/s and the FLOPs over the peak of x's type); and the card's name and
power limit. ``--device auto`` (the default) and ``cuda`` need a card and
raise without one. ``--device cpu`` drives the same code at a small size
(B, H, W = 2, 16, 24) through the plain version: parity only, nothing timed.

Each shape also prints the launch plan at each ``tile_h``
(``kernels/bottleneck.py::plan_report``): pixels a block, blocks, the
weight bytes read from L2, the y1 recompute factor and shared bytes.

``--against DIR`` also runs K3 of the port checkout at ``DIR`` (an earlier
commit, unpacked with ``git archive``) on the same inputs, through that
checkout's own wrapper and library, and times each tile this, other, other,
this in one process (``attention_kernel_bench.load_kernels``). Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from .device import resolve_device
from .kernels import bottleneck as kernels
from .ops.fused_bottleneck import bottleneck_reference, fused_bottleneck

#: (label, (B, H, W, C, M), tile_h sweep), as the JAX tool's.
SHAPES = [
    ("stage1-184x320-c256", (16, 184, 320, 256, 64), (4, 8)),
    ("stage2-92x160-c512", (16, 92, 160, 512, 128), (4,)),
    ("detr-stage1", (8, 184, 320, 256, 64), (8,)),
    ("detr-stage2", (8, 92, 160, 512, 128), (4,)),
    ("detr-stage3", (8, 46, 80, 1024, 256), (2,)),
    ("detr-stage4", (8, 23, 40, 2048, 512), (1,)),
]
#: The size of a ``--device cpu`` drive: (B, H, W) of every shape.
CPU_BHW = (2, 16, 24)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Published H100 SXM peaks (dense): HBM bytes/s; bf16 tensor-core and
# non-tensor float32 FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def flops(B: int, H: int, W: int, C: int, M: int) -> int:
    """Multiply-adds x 2 of the three products: C->M, 3x3 M->M, M->C."""
    return 2 * B * H * W * (C * M + 9 * M * M + M * C)


def bound(B: int, H: int, W: int, C: int, M: int, dtype: torch.dtype) -> tuple[float, str]:
    """(least ms on an H100, "bytes" or "operations"): x read and out written
    once, the weights (x's type) and biases (float32) read once."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * B * H * W * C * item + (2 * C * M + 9 * M * M) * item + (2 * M + C) * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops(B, H, W, C, M) / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def make_inputs(B, H, W, C, M, dtype, device, seed: int = 0):
    """x ~ N(0, 1) NHWC; each weight ~ N(0, 1/fan_in) (LeCun normal, the law
    of the port's ``DETR.init_weights``); biases ~ 0.1 N(0, 1).

    Scaling by fan-in keeps y1, y2 and the expand near unit size at every C
    and M, as frozen BN keeps them in a trained ResNet. The JAX tool's flat
    0.1 law lets them grow with C and M (y2 ~ 20 at stage 4), and a bf16
    comparison then measures their size more than the kernel.
    """
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, dt=dtype, scale=0.1):
        return (scale * torch.randn(shape, generator=g, device=device)).to(dt)

    x = torch.randn((B, H, W, C), generator=g, device=device, dtype=dtype)
    f32 = torch.float32
    return x, (normal(C, M, scale=C**-0.5), normal(M, dt=f32), normal(3, 3, M, M, scale=(9 * M) ** -0.5),
               normal(M, dt=f32), normal(M, C, scale=M**-0.5), normal(C, dt=f32))


def chain_weights(w1, b1, w2, b2, w3, b3):
    """The weights in cuDNN's layout: OIHW in channels-last memory, biases in
    the weights' type."""
    dt = w1.dtype
    oihw = (w1.t()[:, :, None, None], w2.permute(3, 2, 0, 1), w3.t()[:, :, None, None])
    w = [t.contiguous(memory_format=torch.channels_last) for t in oihw]
    return w[0], b1.to(dt), w[1], b2.to(dt), w[2], b3.to(dt)


def cudnn_chain(x, w1, b1, w2, b2, w3, b3):
    """The unfused block in x's type: three cuDNN convolutions on the NCHW view
    of NHWC memory (channels-last), each with its bias and ReLU, and the
    residual. Takes :func:`chain_weights`. The yardstick only: it rounds
    before the bias, where the plain version does not."""
    xc = x.permute(0, 3, 1, 2)
    y = F.relu(F.conv2d(xc, w1, b1), inplace=True)
    y = F.relu(F.conv2d(y, w2, b2, padding=1), inplace=True)
    y = F.conv2d(y, w3, b3)
    return F.relu(y.add_(xc), inplace=True).permute(0, 2, 3, 1)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms of one call over ``iters`` calls after ``warmup``, CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / max(1, |want|))."""
    want = want.float()
    diff = (got.float() - want).abs_()
    return diff.max().item(), diff.div_(want.abs().clamp_(min=1.0)).max().item()


def bf16_verdict(vs_f32: float, vs_exact: float, f32_vs_exact: float, tol: float) -> str:
    """How a bf16 K3 reading stands against its bar ``tol`` (relative to
    max(1, |ref|)), from three readings: the kernel against the plain
    version with exact (float64) sums (the bar reading) and with float32
    sums (the plain version as the JAX package defines it; a diagnostic),
    and the float32 sums against the exact ones.

    "met": within ``tol`` of both. "float32 sums off": within ``tol`` of
    the exact sums, but not of the float32 ones, which are themselves more
    than ``tol`` from exact: their own rounding has moved a y1 or y2 value
    across a bf16 rounding point, which a kernel summing in another order
    does not follow; the bar is met. "failed": anything else.
    """
    if vs_exact > tol:
        return "failed"
    if vs_f32 <= tol:
        return "met"
    return "float32 sums off" if f32_vs_exact > tol else "failed"


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    """Run the sweep; print one line per measurement; return (and with
    ``--json-out`` write) the results."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--json-out", type=Path)
    p.add_argument("--iters", type=int, default=16)
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--device", default="auto")
    p.add_argument("--against", type=Path, help="a port checkout whose K3 is timed beside this one")
    args = p.parse_args(argv)

    device = resolve_device(args.device, args.dtype)  # float32: TF32 off
    on_card = device.type == "cuda"
    if args.against and not on_card:
        raise RuntimeError("--against times K3 on the card and needs one")
    other = None
    if args.against:
        from .attention_kernel_bench import load_kernels

        other = load_kernels(args.against, "bottleneck")
    dtype = DTYPES[args.dtype]
    smi = card() if on_card else "cpu"
    print(f"device: {smi}", flush=True)
    results = {"device": smi, "dtype": args.dtype, "iters": args.iters,
               "against": str(args.against) if args.against else None, "shapes": {}}
    for label, (B, H, W, C, M), tiles in SHAPES:
        if not on_card:
            B, H, W = CPU_BHW
        x, ws = make_inputs(B, H, W, C, M, dtype, device)
        gflop = flops(B, H, W, C, M) / 1e9
        bound_ms, bound_by = bound(B, H, W, C, M, dtype)
        entry = {"shape": [B, H, W, C, M], "gflop": round(gflop, 1),
                 "io_gb": round(2 * B * H * W * C * x.element_size() / 1e9, 3),
                 "bound_ms": bound_ms, "bound_by": bound_by}
        # On the CPU the wrapper runs the plain version itself: its error
        # there is 0, which shows that it took that path. bf16 on the card is
        # also read against the plain version with exact sums.
        want = bottleneck_reference(x, *ws)
        exact = None
        if on_card and dtype == torch.bfloat16:
            exact = bottleneck_reference(x, *ws, accumulate=torch.float64)
            entry["plain_relerr_exact"] = errors(want, exact)[1]
        if on_card:
            cw = chain_weights(*ws)
            t = cuda_ms(lambda: cudnn_chain(x, *cw), args.iters)
            entry.update(cudnn_ms=t, cudnn_tflops=gflop / t,
                         plain_ms=cuda_ms(lambda: bottleneck_reference(x, *ws), max(1, args.iters // 4), 1))
            print(f"{label} {args.dtype}: cuDNN chain {t:.4f} ms ({gflop / t:.1f} TFLOP/s), plain "
                  f"{entry['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        for th in tiles:
            if H % th:
                continue
            report = kernels.plan_report(B, H, W, C, M, th, dtype)
            entry[f"plan_th{th}"] = report
            print(f"{label} {args.dtype}: plan at tile_h={th}: {kernels.describe_plan(report)}", flush=True)
            before = kernels.launch_counts["fused_bottleneck"]
            got = fused_bottleneck(x, *ws, tile_h=th)
            maxerr, relerr = errors(got, want)
            entry[f"cuda_th{th}_maxerr"] = maxerr
            entry[f"cuda_th{th}_relerr"] = relerr
            kind = "K3" if on_card else "plain version (CPU)"
            line = f"{label} {args.dtype}: {kind} tile_h={th} max|err| {maxerr:.3e} (rel {relerr:.3e}"
            if exact is not None:
                entry[f"cuda_th{th}_relerr_exact"] = errors(got, exact)[1]
                line += (f"; against exact sums {entry[f'cuda_th{th}_relerr_exact']:.3e}, float32 sums against "
                         f"exact {entry['plain_relerr_exact']:.3e}")
            line += ")"
            del got
            if on_card:
                t = cuda_ms(lambda: fused_bottleneck(x, *ws, tile_h=th), args.iters)
                entry[f"cuda_th{th}_ms"] = t
                entry[f"cuda_th{th}_tflops"] = gflop / t
                line += f", {t:.4f} ms ({gflop / t:.1f} TFLOP/s, {bound_ms / t:.1%} of the bound)"
            if other is not None:
                mine = lambda: fused_bottleneck(x, *ws, tile_h=th)  # noqa: E731
                theirs = lambda: other.fused_bottleneck(x, *ws, tile_h=th)  # noqa: E731
                entry[f"against_th{th}_maxerr"], entry[f"against_th{th}_relerr"] = errors(theirs(), want)
                abba = [cuda_ms(f, args.iters) for f in (mine, theirs, theirs, mine)]
                entry[f"cuda_th{th}_ms_abba"], entry[f"against_th{th}_ms_abba"] = [abba[0], abba[3]], abba[1:3]
                entry[f"cuda_th{th}_ms"] = (abba[0] + abba[3]) / 2
                entry[f"against_th{th}_ms"] = t_other = (abba[1] + abba[2]) / 2
                line += (f" | A-B-B-A this {abba[0]:.4f} {abba[3]:.4f}, against {abba[1]:.4f} {abba[2]:.4f} ms "
                         f"(rel err {entry[f'against_th{th}_relerr']:.3e}) -> {t_other / entry[f'cuda_th{th}_ms']:.2f}x")
            entry[f"cuda_th{th}_launches"] = kernels.launch_counts["fused_bottleneck"] - before
            print(line, flush=True)
        results["shapes"][label] = entry
        del x, ws, want, exact
        if on_card:
            torch.cuda.empty_cache()

    if args.json_out:
        args.json_out.parent.mkdir(parents=True, exist_ok=True)
        args.json_out.write_text(json.dumps(results, indent=1))
        print(f"wrote {args.json_out}", flush=True)
    return results


if __name__ == "__main__":
    main()
