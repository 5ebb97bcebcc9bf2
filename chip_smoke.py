"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from
``office_person_detection_vit_torch/csrc`` (one nvcc call), holds each against
its plain PyTorch version at the shapes its path gives it, then drives the
port through its entry points ``DETRDetector`` and the fused-bottleneck bench:

1. device: the card's name and power limit; the kernel build and its time;
   each kernel's registers, spills and shared memory (attention K1/K2 and
   the fused bottleneck K3), and the tensor-core instructions (HMMA) in its
   machine code: every bf16 kernel must have them, every float32 one none;
2. kernels against the plain version at the shapes phases 3-5 give them
   (``attention_kernel_bench.CASES``), with times, bounds, the share of the
   bound, SDPA's time and, labelled as such, the time recorded for the
   CUDA-core kernels that the bf16 tensor-core kernels replaced; K1 and K2
   both at the main path's three bf16 shapes, which the dispatch rule
   (``kernels/attention.py::use_flash``) was set from;
3. full-width DETR-R50 detect at 736x1280 in bf16 (random seeded weights),
   whose 18 attention calls per chunk go to K1 or K2 as the dispatch rule
   says (frames/s best and median of 7 runs), and a float32 run of the same
   model on the card against the CPU (plain attention);
4. DETR-DC5 detect, whose 3680-token attention must go through K2;
5. the committed DETR-small checkpoint finds the person drawn into a frame,
   with all 9 of its attention calls through K1;
6. Phase 3-4 (homography -> zones -> counts) on those foot points against
   float64 numpy;
7. the fused bottleneck K3: (a) the bench entry point
   (``bottleneck_kernel_bench``) at its geometries (the JAX tool's two and
   DETR-R50's four stages) in bf16 and in float32, against the plain
   version, and the bf16 plan of each; (b) the 12 identity blocks of a
   full-width DETR-R50 (736x1280, batch 8, float32, seeded random FrozenBN),
   K3 on each folded block against the block's own output; (c) the same 12
   inputs in bf16 against the plain version, with float32 and with exact
   sums (``bottleneck_kernel_bench.bf16_verdict``); each stage timed against
   the cuDNN chain, beside its plan and the recorded time of the CUDA-core
   K3 that the tensor-core body replaced.

Any failed check raises, so the script exits non-zero and prints no result.
Its last two lines are JSON: the kernels (launches, error, times, bound) and
the device.
"""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
import time
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# Recorded times of the attention kernels by (kernel, shape, type): the
# CUDA-core kernels before bf16 moved to the tensor cores, measured by this
# script's phase 2 on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md, "earlier ms").
# That loop also timed the wrapper's host cost, so they are printed beside
# the new times and not divided by them; ``attention_kernel_bench --against``
# times both versions by one method.
EARLIER_MS = {
    ("attention_whole_kv", (8, 8, 920, 920, 32), "bfloat16"): 0.9081,
    ("attention_whole_kv", (8, 8, 100, 920, 32), "bfloat16"): 0.1395,
    ("attention_whole_kv", (8, 8, 100, 100, 32), "bfloat16"): 0.0278,
    ("attention_flash", (2, 8, 3680, 3680, 32), "bfloat16"): 1.5187,
    ("attention_flash", (2, 8, 100, 3680, 32), "bfloat16"): 0.3023,
    ("attention_flash", (8, 8, 920, 920, 32), "bfloat16"): 0.4138,
    ("attention_flash", (8, 8, 920, 920, 32), "float32"): 0.4890,
    ("attention_flash", (2, 8, 100, 920, 32), "float32"): 0.0859,
    ("attention_whole_kv", (2, 8, 100, 100, 32), "float32"): 0.0260,
    ("attention_whole_kv", (1, 8, 84, 84, 16), "float32"): 0.0258,
    ("attention_whole_kv", (1, 8, 25, 84, 16), "float32"): 0.0263,
    ("attention_whole_kv", (1, 8, 25, 25, 16), "float32"): 0.0267,
}
# K3 against the plain version on the same values, relative to max(1,
# |ref|). float32 (TF32 off): summation order only. bf16: two ulps of the
# output, 2^-6 -- one for the output's own rounding, one for a y1 or y2 value
# next to a rounding midpoint that rounds the other way and is carried
# through the next product -- against the plain version with float32 sums
# and with exact sums (bottleneck_kernel_bench.bf16_verdict).
K3_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0**-6}
# The earlier bf16 K3, whose products ran on the CUDA cores, at each DETR-R50
# stage's geometry (B, H, W, C, M): recorded by ``bottleneck_kernel_bench
# --against`` the commit before the tensor-core redesign (that checkout's K3
# beside this one on the same inputs, A-B-B-A in one process, the CUDA-event
# method of phase 7). The float32 body did not change.
K3_EARLIER_SOURCE = ("recorded by bottleneck_kernel_bench --against the commit before the tensor-core "
                     "redesign, on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md, K3's per-stage table)")
K3_EARLIER_MS = {
    (8, 184, 320, 256, 64): 2.7984,
    (8, 92, 160, 512, 128): 2.9616,
    (8, 46, 80, 1024, 256): 4.2549,
    (8, 23, 40, 2048, 512): 9.2364,
}
# K3's tile_h at each DETR-R50 stage at 736x1280 (heights 184/92/46/23), by C.
DETR_TILE_H = {256: 8, 512: 4, 1024: 2, 2048: 1}
# Whole-model float32, card vs CPU: the repo's DETR bar
# (tests/test_detr_parity.py), with TF32 off on the card.
LOGITS_ATOL, LOGITS_RTOL, BOXES_ATOL = 2e-3, 1e-3, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def check_k3_bf16(where: str, vs_f32: float, vs_exact: float, f32_vs_exact: float, unmet: list) -> None:
    """Hold a bf16 K3 reading to ``K3_TOL`` (``bottleneck_kernel_bench.bf16_verdict``):
    fail unless it is within the bar of the plain version with exact sums,
    and of the plain version with float32 sums wherever those are within the
    bar of exact. A reading over the bar against float32 sums that are
    themselves over it goes to ``unmet``, which phase 7 prints as not met."""
    from office_person_detection_vit_torch.bottleneck_kernel_bench import bf16_verdict

    tol = K3_TOL[torch.bfloat16]
    verdict = bf16_verdict(vs_f32, vs_exact, f32_vs_exact, tol)
    check(verdict != "failed", f"K3 {where} bf16: {vs_f32:.3e} from the plain version with float32 sums, "
          f"{vs_exact:.3e} with exact sums (the float32 sums {f32_vs_exact:.3e} from exact); bar {tol:.2e}")
    if verdict == "float32 sums off":
        unmet.append(f"{where}: {vs_f32:.3e}, where the float32 sums are {f32_vs_exact:.3e} from exact")


def load_render_frame():
    spec = importlib.util.spec_from_file_location(
        "synthetic_video", ROOT / "tests" / "helpers" / "synthetic_video.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.render_frame


def sass_hmma(build) -> dict:
    """HMMA instructions (tensor-core products) per function of the built
    library's SASS (``cuobjdump``, beside the nvcc that built it)."""
    hmma = {}
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    check(cuobjdump.exists(), f"{cuobjdump} not found: the tensor-core instructions cannot be read")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.build_library())], capture_output=True, text=True,
                          check=True).stdout
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            hmma[fn] = 0
        elif fn is not None and "HMMA" in line:
            hmma[fn] += 1
    return hmma


def hmma_of(hmma: dict, name: str) -> int:
    """The HMMA count of the one SASS function of a kernel named as the
    attributes entries name it (``base<type,int,...>``). Itanium-mangled
    names carry the base's length and name, then the template arguments: a
    type as one letter (``f`` for float), where the template takes one, and
    each int as ``Li<n>E``."""
    base, args = name.rstrip(">").split("<")
    ints = "".join(f"Li{n}E" for n in args.split(",")[1:])
    mangled = re.compile(rf"{len(base)}{base}I[a-z]?{ints}E")
    counts = [n for f, n in hmma.items() if mangled.search(f)]
    check(len(counts) == 1, f"{name}: {len(counts)} functions of its name in the SASS")
    return counts[0]


def kernel_resources(ka, kb, build) -> None:
    """Phase 1: each kernel's registers, spills and shared memory
    (cudaFuncGetAttributes; dynamic shared memory from its plan at a main
    path or DETR-R50 shape), and the HMMA instructions in its SASS: every
    bf16 kernel must have them, every float32 kernel none."""
    hmma = sass_hmma(build)
    for a in ka.kernel_attributes():
        base, args = a["name"].split("<")
        dtype = torch.bfloat16 if args.startswith("bf16") else torch.float32
        d = int(args.rstrip(">").split(",")[1])
        dyn = ka.whole_kv_plan(920, 920, d, dtype)["smem_bytes"] if "whole_kv" in base else 0
        fits = "whole_kv" not in base or ka.whole_kv_fits(920, d, dtype)
        n_hmma = hmma_of(hmma, a["name"])
        check(bool(n_hmma) == (dtype == torch.bfloat16), f"{a['name']}: {n_hmma} HMMA instructions in its SASS")
        log(f"[1] {a['name']:36s} regs {a['regs']:3d}  spill (local) {a['local_bytes']:4d} B  static smem "
            f"{a['static_smem']:6d} B  dynamic smem {f'{dyn:6d} B' if fits else 'none (K2 at Lk 920)'} at Lk 920  "
            f"HMMA in SASS {n_hmma}")
    # K3: the dynamic shared memory of each instantiation (rows) at a
    # geometry whose plan takes it (bf16: DETR-R50 stage 1 the 160-row
    # tiles, stage 4 the 128-row ones; float32: stage 1 64 rows, stage 4 16,
    # and 32 at M 256 with tile_h 4, which no DETR-R50 stage takes).
    at = {"bottleneck_mma<bf16,5,2,2>": (160, 320, 256, 64, 8, torch.bfloat16),
          "bottleneck_mma<bf16,4,4,1>": (128, 40, 2048, 512, 1, torch.bfloat16),
          "bottleneck_kernel<float,64>": (64, 320, 256, 64, 8, torch.float32),
          "bottleneck_kernel<float,32>": (32, 80, 1024, 256, 4, torch.float32),
          "bottleneck_kernel<float,16>": (16, 40, 2048, 512, 1, torch.float32)}
    attrs = kb.kernel_attributes()
    check(sorted(a["name"] for a in attrs) == sorted(at), f"K3 instantiations {[a['name'] for a in attrs]}")
    for a in attrs:
        want_rows, width, channels, mid, tile_h, dtype = at[a["name"]]
        n_hmma = hmma_of(hmma, a["name"])
        check(bool(n_hmma) == (dtype == torch.bfloat16), f"{a['name']}: {n_hmma} HMMA instructions in its SASS")
        rows, tile_w, smem = kb.plan(width, mid, tile_h, dtype, channels)
        check(rows == want_rows, f"{a['name']}: the plan at W {width}, M {mid}, tile_h {tile_h} takes {rows} rows")
        requested = kb.load_library().bottleneck_smem_bytes(int(dtype == torch.bfloat16), rows, tile_h, tile_w, mid)
        check(requested == smem, f"{a['name']}: the launch requests {requested} B of shared memory, the plan {smem}")
        log(f"[1] {a['name']:36s} regs {a['regs']:3d}  spill (local) {a['local_bytes']:4d} B  static smem "
            f"{a['static_smem']:6d} B  dynamic smem {smem:6d} B at W {width}, M {mid}, tile_h {tile_h} "
            f"({tile_h} x {tile_w}, {rows} rows)  HMMA in SASS {n_hmma}")


def expected_launches(ka, tokens: int, dtype, chunks: int) -> dict:
    """K1/K2 launches of DETR's 6 encoder (tokens keys), 6 cross- (tokens
    keys) and 6 decoder self-attention calls (100 keys) per chunk, by the
    dispatch rule."""
    flash = 6 * (2 * ka.use_flash(tokens, 32, dtype) + ka.use_flash(100, 32, dtype))
    return {"attention_whole_kv": (18 - flash) * chunks, "attention_flash": flash * chunks}


# ------------------------------------------------------------------- phase 7
def bottleneck_phase(frames: np.ndarray, smi: str) -> dict:
    """K3 through the bench entry point and on DETR-R50's 12 identity blocks;
    returns K3's row of the kernels line (stage-1 bench geometry, bf16)."""
    from office_person_detection_vit_torch import bottleneck_kernel_bench as bench
    from office_person_detection_vit_torch.device import resolve_device
    from office_person_detection_vit_torch.kernels import bottleneck as kb
    from office_person_detection_vit_torch.models.detr import DETR, DETRConfig
    from office_person_detection_vit_torch.models.resnet import FrozenBatchNorm
    from office_person_detection_vit_torch.ops.fused_bottleneck import (
        bottleneck_reference, fold_identity_bottleneck, fused_bottleneck,
    )
    from office_person_detection_vit_torch.ops.preprocessing import preprocess_frames

    # (a) the bench entry point: both geometries, in bf16 and in float32
    kb.reset_launch_counts()
    runs = {"bfloat16": bench.main(["--iters", "5"]), "float32": bench.main(["--iters", "3", "--dtype", "float32"])}
    bench_launches = kb.launch_counts["fused_bottleneck"]
    made = sum(v for r in runs.values() for e in r["shapes"].values() for k, v in e.items() if k.endswith("_launches"))
    check(bench_launches > 0 and bench_launches == made,
          f"the bench launched K3 {bench_launches} times, its calls {made}")
    unmet = []  # bf16 readings over the bar against the float32 sums only, where those are off themselves
    for dt, r in runs.items():
        for label, _, tiles in bench.SHAPES:
            e = r["shapes"][label]
            for th in tiles:
                where, rel = f"{label} tile_h {th}", e[f"cuda_th{th}_relerr"]
                if dt == "float32":
                    check(rel <= K3_TOL[torch.float32], f"K3 {where} float32: {rel:.3e} > {K3_TOL[torch.float32]:.1e}")
                else:
                    check_k3_bf16(where, rel, e[f"cuda_th{th}_relerr_exact"], e["plain_relerr_exact"], unmet)
    for label, (B, H, W, C, M), tiles in bench.SHAPES:
        for th in tiles:
            log(f"[7a] {label} tile_h {th} bf16 plan: {kb.describe_plan(kb.plan_report(B, H, W, C, M, th, torch.bfloat16))}")
    log(f"[7a] bench: {bench_launches} K3 launches, every error within tolerance "
        f"(float32 {K3_TOL[torch.float32]:.0e}, bf16 {K3_TOL[torch.bfloat16]:.2e} relative to max(1,|ref|); bf16 "
        f"against the plain version with float32 and with exact sums, {len(unmet)} not met) on {smi}")

    # (b) the 12 identity blocks of a full-width DETR-R50, float32, TF32 off
    resolve_device("cuda", "float32")
    model = DETR(DETRConfig(dtype="float32"))
    model.init_weights(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(7)  # init_weights leaves FrozenBN at the identity
    with torch.no_grad():
        for mod in model.backbone.modules():
            if isinstance(mod, FrozenBatchNorm):
                mod.scale.uniform_(0.5, 1.5, generator=g)
                mod.bias.normal_(0.0, 0.5, generator=g)
    backbone = model.backbone.cuda().eval()
    del model
    blocks = [(n, getattr(backbone, n)) for n in backbone.blocks if getattr(backbone, n).shortcut_conv is None]
    check(len(blocks) == 12, f"DETR-R50 has {len(blocks)} identity blocks, expected 12")
    io = {}

    def keep(mod, inp, out, name):  # NHWC copies of the block's input and output
        io[name] = (inp[0].permute(0, 2, 3, 1).contiguous(), out.permute(0, 2, 3, 1).contiguous())

    hooks = [blk.register_forward_hook(lambda m, i, o, n=n: keep(m, i, o, n)) for n, blk in blocks]
    pixels, _ = preprocess_frames(torch.from_numpy(frames), target_hw=(736, 1280))
    with torch.inference_mode():
        backbone(pixels.cuda())
    for h in hooks:
        h.remove()
    folded = {n: fold_identity_bottleneck(blk) for n, blk in blocks}

    def bf16(ws):
        return [w.bfloat16() if w.dim() > 1 else w for w in ws]

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        kb.reset_launch_counts()
        for n, _ in blocks:
            x, block_out = io[n]
            ws = folded[n]
            if dtype == torch.bfloat16:
                x, ws = x.bfloat16(), bf16(ws)
            got = fused_bottleneck(x, *ws, tile_h=DETR_TILE_H[x.shape[-1]])
            check(bool(torch.isfinite(got).all()), f"K3 {n} {dtype}: non-finite output")
            if dtype == torch.float32:
                errs[n, dtype] = bench.errors(got, block_out)  # (b) the unfolded block's own output
                continue
            # (c) the plain version on the bf16 values, with float32 sums and
            # with exact sums, and the float32 sums' distance from exact
            plain32 = bottleneck_reference(x, *ws)
            exact = bottleneck_reference(x, *ws, accumulate=torch.float64)
            errs[n, dtype] = bench.errors(got, plain32)
            errs[n, "exact"] = bench.errors(got, exact)
            errs[n, "plain"] = bench.errors(plain32, exact)
            check_k3_bf16(n, errs[n, dtype][1], errs[n, "exact"][1], errs[n, "plain"][1], unmet)
            del exact, plain32
        launches = kb.launch_counts["fused_bottleneck"]
        check(launches == len(blocks), f"the {dtype} identity blocks launched K3 {launches} times, expected 12")
        worst = max(errs[n, dtype][1] for n, _ in blocks)
        if dtype == torch.float32:
            check(worst <= K3_TOL[dtype], f"K3 on DETR-R50 blocks float32: relative error {worst:.3e} > {K3_TOL[dtype]:.1e}")
            log(f"[7b] DETR-R50 identity blocks float32: {launches} K3 launches; max |err| relative to max(1,|ref|) "
                f"{worst:.3e} (tol {K3_TOL[dtype]:.1e}) against the unfolded block")
        else:
            log(f"[7c] DETR-R50 identity blocks bfloat16: {launches} K3 launches; max |err| relative to max(1,|ref|) "
                f"against the plain version {worst:.3e} with float32 sums, "
                f"{max(errs[n, 'exact'][1] for n, _ in blocks):.3e} with exact sums (tol {K3_TOL[dtype]:.2e})")
    for n, _ in blocks:
        x = io[n][0]
        verdict = bench.bf16_verdict(errs[n, torch.bfloat16][1], errs[n, "exact"][1], errs[n, "plain"][1],
                                     K3_TOL[torch.bfloat16])
        log(f"     {n:13s} {str(tuple(x.shape)):22s} float32 err {errs[n, torch.float32][0]:.3e} "
            f"(rel {errs[n, torch.float32][1]:.3e}); bf16 err {errs[n, torch.bfloat16][0]:.3e} "
            f"(rel {errs[n, torch.bfloat16][1]:.3e} against float32 sums, {errs[n, 'exact'][1]:.3e} against exact "
            f"sums; float32 sums against exact {errs[n, 'plain'][1]:.3e}): {verdict}")
    for u in unmet:
        log(f"[7] NOT MET: bf16 K3 over {K3_TOL[torch.bfloat16]:.2e} against the plain version with float32 sums "
            f"at {u}")

    # Each stage's first identity block, timed against the cuDNN chain
    log("[7] per-stage block times (CUDA events, mean of 5 after 2 warm-up; plain: 2 after 1); "
        f"the CUDA-core K3 {K3_EARLIER_SOURCE}")
    for n in ("stage0_layer1", "stage1_layer1", "stage2_layer1", "stage3_layer1"):
        for dtype in (torch.float32, torch.bfloat16):
            x, ws = io[n][0], folded[n]
            if dtype == torch.bfloat16:
                x, ws = x.bfloat16(), bf16(ws)
            B, H, W, C = x.shape
            M = ws[0].shape[1]
            th = DETR_TILE_H[C]
            cw = bench.chain_weights(*ws)
            ms = bench.cuda_ms(lambda: fused_bottleneck(x, *ws, tile_h=th), 5)
            cudnn = bench.cuda_ms(lambda: bench.cudnn_chain(x, *cw), 5)
            plain = bench.cuda_ms(lambda: bottleneck_reference(x, *ws), 2, 1)
            bound_ms, bound_by = bench.bound(B, H, W, C, M, dtype)
            gflop = bench.flops(B, H, W, C, M) / 1e9
            was = K3_EARLIER_MS[B, H, W, C, M] if dtype == torch.bfloat16 else None
            log(f"     {n:13s} {str((B, H, W, C, M)):24s} {str(dtype)[6:]:8s} tile_h {th}: K3 {ms:.4f} ms "
                f"({gflop / ms:.1f} TFLOP/s) cuDNN chain {cudnn:.4f} plain {plain:.4f} bound {bound_ms:.4f} ({bound_by})"
                + ("" if was is None else f" [CUDA-core K3 {was:.4f} ms, recorded]"))
            log(f"       plan: {kb.describe_plan(kb.plan_report(B, H, W, C, M, th, dtype))}")
    del io, folded, backbone
    torch.cuda.empty_cache()

    # K3's row: the bf16 stage-1 bench geometry at tile_h 8, with the
    # launches of that run (its error check, warm-up and timed calls).
    label = bench.SHAPES[0][0]
    e = runs["bfloat16"]["shapes"][label]
    return {
        "name": "fused_bottleneck", "route": "cuda", "source": "office_person_detection_vit_torch/csrc/bottleneck.cu",
        "replaces": "office_person_detection_vit_tpu/ops/fused_bottleneck.py:47", "launches": e["cuda_th8_launches"],
        "launches_on": f"bottleneck_kernel_bench {label} bfloat16 tile_h 8, phase 7a",
        "max_abs_err": e["cuda_th8_maxerr"], "ms": e["cuda_th8_ms"], "plain_ms": e["plain_ms"],
        "bound_ms": e["bound_ms"], "bound_by": e["bound_by"], "library_ms": e["cudnn_ms"],
        "shape": e["shape"], "dtype": "bfloat16", "tile_h": 8, "detr_block_launches": 2 * len(blocks),
        "bf16_not_met_against_float32_sums": unmet,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card only", file=sys.stderr)
        return 1
    from office_person_detection_vit_torch import attention_kernel_bench as abench
    from office_person_detection_vit_torch.detection.detector import DETRDetector
    from office_person_detection_vit_torch.device import resolve_device
    from office_person_detection_vit_torch.kernels import attention as ka
    from office_person_detection_vit_torch.kernels import bottleneck as kb
    from office_person_detection_vit_torch.kernels import build
    from office_person_detection_vit_torch.models.detr import DETR, DETRConfig
    from office_person_detection_vit_torch.ops.aggregation import zone_count_matrix
    from office_person_detection_vit_torch.ops.geometry import homography_transform, validate_homography
    from office_person_detection_vit_torch.ops.preprocessing import preprocess_frames
    from office_person_detection_vit_torch.ops.zones import ZoneClassifier

    # ---- 1. device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[1] card: {smi}")
    t0 = time.perf_counter()
    ka.load_library()
    kb.load_library()
    log(f"[1] built and loaded the kernel library ({', '.join(p.name for p in build.sources())}; "
        f"one nvcc call, sm_90a) in {time.perf_counter() - t0:.1f} s")
    kernel_resources(ka, kb, build)

    # ---- 2. kernels against the plain version at the main-path shapes
    log("[2] kernels vs plain version (device ms: mean of 20 calls queued behind a sleep kernel, after 3 "
        "warm-up calls; attention_kernel_bench.cuda_ms)")
    bf16 = torch.bfloat16
    rows = {}
    for seed, case in enumerate(abench.CASES):
        row = abench.measure(ka, case, seed)
        name, shape, dt = case[:3]
        was = EARLIER_MS.get((name, shape, dt))
        was = "-" if was is None else f"{was:.4f}"
        log(f"  {abench.describe(row)} [CUDA-core ms {was}, recorded, host cost included]")
        rows[name, shape, dt] = row
    for shape in ((8, 8, 920, 920, 32), (8, 8, 100, 920, 32), (8, 8, 100, 100, 32)):  # DETR-R50, B 8
        t1, t2 = (rows[name, shape, "bfloat16"]["ms"] for name in ("attention_whole_kv", "attention_flash"))
        rule = "K2" if ka.use_flash(shape[3], shape[4], bf16) else "K1"
        log(f"[2] dispatch at {shape} bf16: K1 {t1:.4f} ms, K2 {t2:.4f} ms -> faster {'K1' if t1 <= t2 else 'K2'}; "
            f"use_flash takes {rule}")

    render_frame = load_render_frame()
    t_start = datetime(2025, 1, 20, 9, 0, 0)
    frames = np.stack([
        render_frame(t_start + timedelta(minutes=5 * i),
                     people=[(300 + 20 * i, 300, 0), (800 - 15 * i, 360, 1)], seed=i)
        for i in range(19)
    ])  # 16 frames = two full chunks of 8, plus a tail of 3 (bucket 4)

    # ---- 3. full-width DETR-R50 detect, bf16
    det = DETRDetector({
        "detection.model_size": "full", "detection.dtype": "bfloat16", "detection.device": "cuda",
        "detection.batch_size": 8, "detection.input_height": 736, "detection.input_width": 1280,
        "detection.confidence_threshold": 0.5, "detection.nms_threshold": 0.4,
    })
    det.load_model()
    det.detect_batch(frames[:8])  # warm-up (cuDNN algorithm choice)
    torch.cuda.synchronize()
    ka.reset_launch_counts()
    batch = det.detect_batch(frames)
    main_counts = dict(ka.launch_counts)
    chunks = 3
    check(batch.boxes_xywh.shape == (19, 100, 4), f"detect_batch shape {batch.boxes_xywh.shape}")
    check(all(np.isfinite(a).all() for a in (batch.boxes_xywh, batch.scores, batch.foot)), "non-finite detections")
    want_main = expected_launches(ka, 920, bf16, chunks)
    check(main_counts == want_main and sum(main_counts.values()) == 18 * chunks,
          f"full-width detect launched {main_counts}, expected {want_main} (18 per chunk x {chunks})")
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        det.detect_batch(frames[:16])
        times.append(time.perf_counter() - t)
    fps = sorted(16 / t for t in times)
    log(f"[3] DETR-R50 bf16 736x1280 batch 8: launches {main_counts} over {chunks} chunks "
        f"(18 per chunk, as use_flash says); {fps[-1]:.2f} frames/s best, {fps[len(fps) // 2]:.2f} median, "
        f"{fps[0]:.2f} worst (7 runs x 16 frames, host clock, uint8 frames in, DetectionBatch out) on {smi}")
    det.cleanup()

    resolve_device("cuda", "float32")  # TF32 off for the float32 comparison
    cfg32 = DETRConfig(dtype="float32")
    cpu_model = DETR(cfg32)
    cpu_model.init_weights(torch.Generator().manual_seed(0))
    cpu_model.eval()
    gpu_model = DETR(cfg32).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.cuda()
    pixels, mask = preprocess_frames(torch.from_numpy(frames[:2]), target_hw=(736, 1280))
    ka.reset_launch_counts()
    with torch.inference_mode():
        got = gpu_model(pixels.cuda(), mask.cuda())
        torch.cuda.synchronize()
        f32_counts = dict(ka.launch_counts)
        want = cpu_model(pixels, mask)
    d_logits = (got["logits"].cpu() - want["logits"]).abs()
    d_boxes = (got["boxes"].cpu() - want["boxes"]).abs().max().item()
    logits_ok = bool((d_logits <= LOGITS_ATOL + LOGITS_RTOL * want["logits"].abs()).all())
    check(f32_counts == {"attention_whole_kv": 6, "attention_flash": 12},
          f"float32 forward launched {f32_counts}, expected 6 K1 + 12 K2")
    check(logits_ok and d_boxes <= BOXES_ATOL,
          f"float32 card vs CPU: max|dlogits| {d_logits.max().item():.2e}, max|dboxes| {d_boxes:.2e}")
    log(f"[3] float32 DETR-R50 on the card (K1 x6, K2 x12) vs CPU (plain): max|dlogits| "
        f"{d_logits.max().item():.2e} (atol {LOGITS_ATOL} rtol {LOGITS_RTOL}), max|dboxes| {d_boxes:.2e} (atol {BOXES_ATOL})")
    del cpu_model, gpu_model, got

    # ---- 4. DETR-DC5 detect: 3680 tokens go through K2
    dc5 = DETRDetector({
        "detection.model_size": "full", "detection.dtype": "bfloat16", "detection.device": "cuda",
        "detection.dilate_c5": True, "detection.batch_size": 2, "detection.input_height": 736,
        "detection.input_width": 1280, "detection.nms_threshold": 0.4,
    })
    dc5.load_model()
    dc5.detect_batch(frames[:2])  # warm-up
    ka.reset_launch_counts()
    dc5_batch = dc5.detect_batch(frames[:2])
    dc5_counts = dict(ka.launch_counts)
    check(np.isfinite(dc5_batch.boxes_xywh).all(), "non-finite DC5 detections")
    want_dc5 = expected_launches(ka, 3680, bf16, 1)
    check(dc5_counts == want_dc5, f"DC5 detect launched {dc5_counts}, expected {want_dc5}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    dc5.detect_batch(frames[:2])
    log(f"[4] DETR-DC5 bf16 736x1280 batch 2: launches {dc5_counts}; "
        f"{2 / (time.perf_counter() - t):.2f} frames/s on {smi}")
    dc5.cleanup()

    # ---- 5. the committed DETR-small checkpoint finds the drawn person
    small = DETRDetector({
        "detection.model_size": "small", "detection.score_mode": "sigmoid",
        "detection.checkpoint_path": str(ROOT / "docs" / "artifacts" / "detr_small_weights.npz"),
        "detection.device": "cuda", "detection.dtype": "float32",
        "detection.input_height": 224, "detection.input_width": 384,
        "detection.confidence_threshold": 0.2, "detection.nms_threshold": 0.3,
        "detection.batch_size": 1,
    })
    px, py = 500, 350
    frame = render_frame(t_start, people=[(px, py, 2)], seed=4)
    small.load_model()
    ka.reset_launch_counts()
    dets = small.detect(frame)
    small_counts = dict(ka.launch_counts)
    check(small_counts == {"attention_whole_kv": 9, "attention_flash": 0},
          f"DETR-small detect launched {small_counts}, expected 9 K1 (3 encoder, 3+3 decoder)")
    check(len(dets) >= 1, "the small checkpoint detected nobody")
    want_c = (px + 25.0, py - 26 + 156 / 2)  # GT box (x, y - 26, 50, 156)
    dist = min(max(abs(d.bbox[0] + d.bbox[2] / 2 - want_c[0]), abs(d.bbox[1] + d.bbox[3] / 2 - want_c[1]))
               for d in dets)
    check(dist < 60, f"no detection within 60 px of the person at {want_c}: {[d.bbox for d in dets]}")
    log(f"[5] DETR-small checkpoint: launches {small_counts}; {len(dets)} detection(s), "
        f"nearest centre {dist:.1f} px from the person")

    # ---- 6. Phase 3-4 on the detections' foot points
    H = np.array([
        [-0.8795888447, -2.8974379541, 417.8510123786],
        [-1.5459702925, -3.4570021203, 1054.0107447082],
        [-0.0011928509, -0.0035480452, 1.0000000000],
    ])
    zones = [
        {"id": f"zone_{i + 1}", "polygon": [[x0, 912], [x0 + 236, 912], [x0 + 236, 1350], [x0, 1350]], "priority": i + 1}
        for i, x0 in enumerate((859, 1095, 1331))
    ]
    validate_homography(H)
    foot = np.asarray([d.foot_point for d in dets], np.float32)
    floor = homography_transform(torch.tensor(H, dtype=torch.float32, device="cuda"),
                                 torch.from_numpy(foot).cuda()).cpu().numpy()
    hom = np.c_[foot.astype(np.float64), np.ones(len(foot))] @ H.T
    floor64 = hom[:, :2] / hom[:, 2:]
    check(np.abs(floor - floor64).max() < 1e-2, f"homography off float64 by {np.abs(floor - floor64).max():.3e} px")
    zc = ZoneClassifier(zones, device="cuda")
    membership = zc.membership(floor64)
    counts = zone_count_matrix(torch.from_numpy(membership[None]).cuda(),
                               torch.ones(1, len(foot), dtype=torch.bool, device="cuda")).cpu().numpy()[0]
    x, y = floor64[:, 0:1], floor64[:, 1:2]
    x0 = np.asarray([z["polygon"][0][0] for z in zones])[None]
    want_counts = ((x > x0) & (x < x0 + 236) & (y > 912) & (y < 1350)).sum(0)
    check(np.array_equal(counts, want_counts), f"zone counts {counts} != float64 {want_counts}")
    check(counts.sum() >= 1, f"no detection in a zone: floor points {floor64.tolist()}")
    log(f"[6] Phase 3-4: floor points {np.round(floor64, 1).tolist()}, zone counts {counts.tolist()} "
        f"(float64 numpy agrees; max homography gap {np.abs(floor - floor64).max():.2e} px)")

    del small
    k3_row = bottleneck_phase(frames[:8], smi)

    # ---- result
    replaces = {"attention_whole_kv": "office_person_detection_vit_tpu/ops/attention.py:60",
                "attention_flash": "office_person_detection_vit_tpu/ops/attention.py:159"}
    # Each attention kernel's row at the encoder shape of the path that
    # launches it, beside that path's own count: K2 runs the bf16 main path
    # (use_flash sends every bf16 call to it), K1 the float32 DETR-small.
    headline = {
        "attention_whole_kv": (("attention_whole_kv", (1, 8, 84, 84, 16), "float32"), small_counts,
                               "DETR-small float32 detect, phase 5"),
        "attention_flash": (("attention_flash", (8, 8, 920, 920, 32), "bfloat16"), main_counts,
                            "DETR-R50 bf16 detect, phase 3 (the main path)"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": "office_person_detection_vit_torch/csrc/attention.cu",
         "replaces": replaces[name], "launches": counts[name], "launches_on": path,
         **{k: rows[key][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                      "shape", "dtype", "instruction")}}
        for name, (key, counts, path) in headline.items()
    ] + [k3_row]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
