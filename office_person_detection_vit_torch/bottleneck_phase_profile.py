"""Where the bf16 fused bottleneck (K3) spends its time, on the card.

    python -m office_person_detection_vit_torch.bottleneck_phase_profile \\
        [--json-out PATH] [--iters 10]

At DETR-R50's four identity-block stages (``bottleneck_kernel_bench``'s
``detr-stage*`` geometries, bench inputs) it reports:

* per product of K3 (the 1x1 reduce, the 3x3, the 1x1 expand), the cycles
  a block spends waiting for its copies and the barrier, issuing the next
  chunk's copies (thread 0 issues the reduce's ``cp.async`` copies of x
  rows, which stall there when the memory system holds them back; another
  thread starts the weights' TMA copies, so their stall shows in thread 0's
  wait), multiplying, and in the epilogue. They come from a build of
  ``csrc/bottleneck.cu`` with ``-DK3_PHASE_PROFILE``, whose ``clock64()``
  counters time the phases of its pipeline (thread 0 of each block, summed
  over the blocks with atomics); the counters cost a few percent, and that
  build's time is printed beside the kernel's own;
* the kernel's own time (``kernels/bottleneck.py``) at the plan's tiles, at
  other patch widths of the same tiles, and at the plan's patch with the
  other tiles where they cover it (``_launch``), with the weight bytes read
  from L2, so that the plan's choice can be checked.

Times are CUDA events (``bottleneck_kernel_bench.cuda_ms``). Needs a card
and ``nvcc``; raises without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from . import bottleneck_kernel_bench as bench
from .kernels import bottleneck as kb
from .kernels import build
from .kernels.build import BLOCK_SMEM_BYTES

PRODUCTS = ("reduce", "3x3", "expand")
PHASES = ("wait", "issue", "products", "epilogue")
#: Other patch widths timed beside the plan's at each stage, with its tiles.
OTHER_TILE_W = {"detr-stage1": (10, 12), "detr-stage2": (14, 18), "detr-stage3": (16, 20), "detr-stage4": (20,)}

#: The nvcc define that builds the counters into ``csrc/bottleneck.cu``.
PROFILE_DEFINES = ("-DK3_PHASE_PROFILE",)


def instrumented_library() -> ctypes.CDLL:
    """The kernel library built with :data:`PROFILE_DEFINES` (an nvcc a
    source, cached under its own key beside the library's), loaded."""
    lib = ctypes.CDLL(str(build.build_library(PROFILE_DEFINES)))
    lib.fused_bottleneck.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.phase_cycles.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(lib, x, ws, tile_h: int, tile_w: int, rows: int) -> torch.Tensor:
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    err = lib.fused_bottleneck(1, x.data_ptr(), *(w.data_ptr() for w in ws), out.data_ptr(), B, H, W, C,
                               ws[0].shape[1], tile_h, tile_w, rows, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"instrumented K3 launch failed ({err})")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--json-out", type=Path)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the phase profile runs K3 on the card and needs one")
    smi = bench.card()
    print(f"device: {smi}", flush=True)
    lib = instrumented_library()
    results = {"device": smi, "iters": args.iters, "stages": {}}
    for label, (B, H, W, C, M), (tile_h,) in (s for s in bench.SHAPES if s[0].startswith("detr-")):
        x, ws = bench.make_inputs(B, H, W, C, M, torch.bfloat16, "cuda")
        plan = kb.plan_report(B, H, W, C, M, tile_h, torch.bfloat16)
        rows = plan["rows"]
        want = kb.fused_bottleneck(x, *ws, tile_h=tile_h)
        got = launch(lib, x, ws, tile_h, plan["tile_w"], rows)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: the instrumented build's output differs from K3's")
        counts = (ctypes.c_ulonglong * 16)()
        build.check_launch(lib, "phase_cycles", lib.phase_cycles(counts))  # read and reset
        launch(lib, x, ws, tile_h, plan["tile_w"], rows)
        torch.cuda.synchronize()
        build.check_launch(lib, "phase_cycles", lib.phase_cycles(counts))
        blocks = counts[15]
        cycles = {f"{prod} {ph}": counts[4 * i + k] / blocks for i, prod in enumerate(PRODUCTS)
                  for k, ph in enumerate(PHASES)}
        entry = {"shape": [B, H, W, C, M], "plan": plan, "blocks_counted": blocks, "cycles_a_block": cycles,
                 "ms": bench.cuda_ms(lambda: kb.fused_bottleneck(x, *ws, tile_h=tile_h), args.iters),
                 "instrumented_ms": bench.cuda_ms(lambda: launch(lib, x, ws, tile_h, plan["tile_w"], rows), args.iters),
                 "other_tiles": {}, "other_rows": {}}
        print(f"{label} {(B, H, W, C, M)}: plan {kb.describe_plan(plan)}; K3 {entry['ms']:.4f} ms "
              f"(instrumented {entry['instrumented_ms']:.4f})", flush=True)
        print("  cycles a block, " + " / ".join(PHASES) + ": " + "; ".join(
            f"{prod} " + " / ".join(f"{cycles[f'{prod} {ph}']:.0f}" for ph in PHASES) for prod in PRODUCTS), flush=True)
        for tile_w in OTHER_TILE_W[label]:
            if (tile_h + 2) * (tile_w + 2) > rows:
                continue
            ms = bench.cuda_ms(lambda: kb._launch(x, *ws, tile_h, tile_w, rows), args.iters)
            blocks_w = B * (H // tile_h) * -(-W // tile_w)
            entry["other_tiles"][tile_w] = {"ms": ms, "blocks": blocks_w,
                                            "weight_l2_bytes": blocks_w * (2 * C * M + 9 * M * M) * 2}
            print(f"  {tile_h} x {tile_w} with the same tiles: {ms:.4f} ms, {blocks_w} blocks, "
                  f"{entry['other_tiles'][tile_w]['weight_l2_bytes'] / 1e9:.3f} GB of weights from L2", flush=True)
        tile_w = plan["tile_w"]
        for other in kb.MMA_TILES:
            if other == rows or (tile_h + 2) * (tile_w + 2) > other or \
                    kb.smem_bytes(other, tile_h, tile_w, M, torch.bfloat16) > BLOCK_SMEM_BYTES:
                continue
            ms = bench.cuda_ms(lambda: kb._launch(x, *ws, tile_h, tile_w, other), args.iters)
            entry["other_rows"][other] = ms
            print(f"  {tile_h} x {tile_w} with the {other}-row tiles: {ms:.4f} ms", flush=True)
        results["stages"][label] = entry
        del x, ws, want, got
        torch.cuda.empty_cache()
    if args.json_out:
        args.json_out.parent.mkdir(parents=True, exist_ok=True)
        args.json_out.write_text(json.dumps(results, indent=1))
        print(f"wrote {args.json_out}", flush=True)
    return results


if __name__ == "__main__":
    main()
