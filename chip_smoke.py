"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 10a   # B.4 and its backward pair alone
    python3 chip_smoke.py --phase 11    # the tracking slice alone
    python3 chip_smoke.py --phase 12    # the ViT slice alone
    python3 chip_smoke.py --phase 13    # the detector slice alone
    python3 chip_smoke.py --phase 14    # head dims above 128, training, export, serving, scale-out
    python3 chip_smoke.py --phase 15    # CLIP Re-ID, the new outputs, RANSAC, diagnostics, benchmark CLI

Builds the hand-written CUDA kernels from
``office_person_detection_vit_torch/csrc`` (one nvcc call), holds each against
its plain PyTorch version at the shapes its path gives it, then drives the
port through its entry points ``DETRDetector``, the fused-bottleneck bench
the pipeline phases 2-4, the entry point and the trainer:

1. device: the card's name and power limit; the kernel build and its time;
   each kernel's registers, spills and shared memory (attention K1/K2 and
   the fused bottleneck K3), and the tensor-core instructions in its
   machine code: every bf16 kernel must have them (HMMA; the Hopper bodies
   ``*_wgmma`` HGMMA and UTMALDG, the TMA's loads, and no spill), every
   float32 one none;
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
   K3 that the tensor-core body replaced;
8. the slice, phases 2-4 through the port's own phases: (a) DETR-R50 bf16
   at 736x1280 over 288 rendered frames (a day at 5-minute intervals)
   through ``DetectionPhase`` -> ``TransformPhase`` -> ``AggregationPhase``
   (18 K2 launches a chunk, the four artifacts with the JAX keys, a
   ``zone_counts.csv`` row a frame, each phase's wall time), then the
   transform and aggregation phases at a user's load (288 frames x 50
   detections) with homography, PWA and TPS, lens undistortion and both
   overlap modes, held against float64 numpy; (b) the committed DETR-small
   checkpoint through the phases, whose zone counts must place each drawn
   person in their zone, with its features and attention map;
9. the whole flow through the port's entry point
   ``office_person_detection_vit_torch.main.main`` (what ``python -m
   office_person_detection_vit_torch --config <yaml>`` runs), from a video to
   ``summary.json``: (a) a 2-hour 720p timelapse (08:00-10:00, ratio 313),
   DETR-R50 bf16 at 736x1280, batch 8, seeded random weights, the shipped
   ``detection.transfer_format: auto`` (the race's pick): every 5-minute
   target extracted with the timestamp the video burned in, each phase's
   checkpoint, the artifacts with the JAX keys and the JSON schemas, a
   floormap PNG a frame, 18 K2 launches a chunk, each phase's seconds; (b)
   the committed DETR-small checkpoint on a one-hour video, run on the card
   and on the CPU: the same extraction, detections matched one to one, floor
   points and zone counts; (c) the card session resumed: phases 1-4 skipped,
   no kernel launch and no frame decoded, the same ``zone_counts.csv``. The
   videos are written by a child process while phases 1-8 run. Phase 5's
   three charts are drawn (with OpenCV; the card machine has no matplotlib);
10. the training slice: (a) B.4, the differentiable attention
   (``ops.attention.KernelAttention``: K1/K2 forward writing each row's
   log-sum-exp, the backward kernel pair ``attention_backward``), at
   DETR-R50's training shapes at 768x1344 in bf16 and DETR-small's in
   float32: the forward's output bit-identical with and without the
   log-sum-exp (also at the detect path's three shapes) and the log-sum-exp
   against ``attention_lse``; the forward at the kernels' bars; dq/dk/dv
   against float64 autograd of the plain version (the gate) and against the
   pair's plain version (``attention_backward_reference``), two calls
   bit-identical, the plain bf16 autograd's own error printed beside them;
   forward+backward, the forward and the backward timed against plain
   autograd, the plain version of the pair and SDPA (and SDPA's backward
   alone); (b) DETR-R50 bf16 (float32 master weights) at 768x1344, batch 8,
   dropout 0.1, aux loss, augmentation, on 16 synthetic 720p images
   (``tools/gen_recipe_dataset.py``, a child process) through the port's
   ``COCOBatchLoader``: 2 warm-up and 6 timed steps, the split of a step, 18
   K2 launches through B.4 and 18 backward pairs a step, finite losses,
   every parameter moved; (c) the committed DETR-small checkpoint, one
   float32 step on the card and one on the CPU: the same matches, losses and
   gradients; (d) ``main --fine-tune`` with the ``training.*`` keys at full
   size for one epoch, and its ``weights.npz`` in ``DETRDetector`` on the
   card;
11. the tracking slice (Phase 2.5): (a) a workday of dense tracking (8
   hours on the 10 s grid, 2,880 frames of 30 people on seeded random walks,
   box noise, 5% dropped, 2 false positives a frame, 256-d features, 64
   slots) through the scan tracker on the card, inside
   ``torch.cuda.set_sync_debug_mode("error")``, through the port's scan on
   the CPU (the same ids, exactly) and through the cascade on the host: each
   engine's MOTA, IDF1 and HOTA (the port's ``mot_metrics``) against the
   generator's ground truth (the four scorings in parallel processes),
   seconds a 1,000 frames, the scan's device
   operations a frame (``torch.profiler``); (b) the committed showcase
   (``tools/e2e_showcase.py`` gen-video, gen-config, gold-gt, in child
   processes): the DETR-small checkpoint through ``main`` on the card with
   tracking and dense tracking, then Phases 2-5 of the same session on the
   CPU (a copy resumed after 01_extraction): MOTA and IDF1 within 0.01 of
   the CPU's, ``tracks_mot.csv`` row for row where the detections pair,
   ``zone_counts.csv`` with one count a track id a 5-minute window; (c)
   DETR-R50 bf16 over 8a's 288 frames into ``TrackingPhase`` (cascade, then
   scan on the card, the same ids as the CPU scan), ``TransformPhase`` and
   ``AggregationPhase``, each phase's seconds;
12. the ViT slice (ViT-base/16 as DETR's backbone, head dim 64): (a) every
   head-dim-64 body's registers, spills (none allowed) and HMMA, HGMMA and
   UTMALDG counts (K2 and the pair run the Hopper bodies); K1
   and K2 at head dim 64 and at a padded 48 in both types against the plain
   version, the ViT's main-path shape (8, 12, 3681, 3681, 64) timed against
   SDPA and the bound; B.4 at [10a]'s gate at head dim 64 and 48; B.4 at
   ViT-base's training shape (8, 12, 4033, 4033, 64) timed against SDPA;
   (b) ViT-base/16 DETR detect at 736x1280, bf16, batch 8 through
   ``DETRDetector`` (30 K2 a chunk, frames/s), the float32 model on the card
   against the CPU at the DETR bar, and ``main`` with ``detection.backbone:
   vit`` on the one-hour video; (c) ViT-base/16 DETR training at 768x1344,
   bf16, batch 8 (6 timed steps, their split, 30 B.4 pairs a step, every
   parameter with a gradient moved), then ``train_detr --backbone vit``;
   (d) ``main --evaluate`` and the trainer's ``--evaluate`` with the DETR-small
   checkpoint against a ground-truth file of the persons drawn into the
   one-hour video, card tp/fp/fn within 1 of the CPU's.
13. the detector slice: (a) head dims up to 128 (C.7): every head-dim-128
   body's registers, spills (none allowed) and HMMA, HGMMA and UTMALDG
   counts; K1/K2 at ViT-H's
   head dim 80 (padded to 128) and at 128 in both types against the plain
   version, timed against SDPA and the bound; B.4 at [10a]'s gate at 128 and
   80; then DETR with ViT-H/16's widths (4 of 32 layers) through
   ``detect_batch``, its float32 forward at 224x224 card against CPU, and 8
   of its training steps, which launch the D-128 bodies; (b) the upload
   routes (A.4, A.9): [8a]'s 288 frames through DETR-R50 bf16 on bgr, i420
   and i420d (i420d's detections equal to i420's bit for bit), the staging
   library's bytes equal to cv2's, the float32 i420 forward card against CPU,
   ``auto``'s race; (c) YOLOv8x and the single-shot detector (A.7b) at
   736x1280, bf16, batch 8 (frames/s), each in float32 card against CPU, the
   ultralytics ``.pt`` route on the card, and ``main`` with
   ``detection.model: yolo`` on the one-hour video.
14. the scale-out slice: (a) head dims above 128 (C.7 closed): every
   chunked body's registers, spills (none allowed) and HMMA count (none:
   CUDA cores), and every Hopper body at 192 and 256 (bf16 K2 and the
   pair: no spill, HGMMA and UTMALDG, no HMMA); K1/K2 at head dims 136, 192
   and 256 in both types and bf16 K2 at 320 against the plain version, timed
   against SDPA and the bound; B.4 at [10a]'s gate at the same head dims and
   bf16 at 320; DETR with a ViT of
   256-wide heads through ``detect_batch`` (K2 on the Hopper body), its
   float32 forward card against CPU (K1, chunked), and 8 of its training
   steps (B.4 on the Hopper bodies); (b) YOLOv8x and the
   single-shot detector trained at 768x1344, bf16, batch 8 (ms a step,
   images/s, peak memory, falling losses), a float32 step of each on the
   card against the CPU, and ``main --fine-tune`` with ``training.model:
   yolo`` whose weights detect; (c) DETR-R50 bf16 exported
   (``torch.export``, symbolic batch; the attention is the port's operator)
   and served by ``serve.py --artifact`` in a fresh process: 8 concurrent
   JPEG posts coalesced, detections against ``detect_batch``, K2's launches
   read from ``/stats``; (d) ``torchrun --nproc_per_node 1`` on NCCL: the
   sharded DETR and YOLO steps against the one-process step.
15. the last modules: (a) the CLIP image tower of Re-ID's ``model_type:
   clip`` at openai/clip-vit-base-patch32's widths (seeded weights written
   as a HF directory, loaded through ``ReIDFeatureExtractor``): 12 K1
   launches a call of 64 crops, features card against CPU, crops/s, and K1
   at (64, 12, 50, 50, 64) float32 against the plain version, SDPA and the
   bound; (b) [8a]'s frames into ``TrackingPhase`` with CLIP Re-ID (cascade,
   then the scan on the card with the CPU scan's ids); (c) ``main`` with
   ``output.save_attention_maps`` and ``save_side_by_side_video`` resumed
   after [9b]'s Phase 1: an overlay a frame, the attention maps card against
   CPU, the mp4 read back; (d) RANSAC (2,000 correspondences, 512
   hypotheses) card against CPU, ``FeatureVisualizer`` on 3,000 of [11a]'s
   features (silhouette card against CPU, KMeans against the true ids,
   t-SNE's seconds), ``python -m ...benchmark`` on [11b]'s tracks and
   ``SessionDataLoader`` over [9a]'s and [15c]'s sessions.

Any failed check raises, so the script exits non-zero and prints no result.
Its last two lines are JSON: the kernels (launches, error, times, bound; K1,
K2, K3, B.4 and its backward pair, K2, B.4 and the pair at head dim 64 on
the ViT's path, K1, K2, B.4 and the pair at head dim 128 on the ViT-H-width path,
the chunked bodies above head dim 128 on the VITW path, and K1 on the CLIP
path) and the device.
"""

from __future__ import annotations

import contextlib
import csv
import importlib.util
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# through the next product. The bf16 bar is read against the plain version
# with exact (float64) sums. The reading against float32 sums is printed as a
# diagnostic and must also be within the bar, except where those float32 sums
# are themselves more than the bar from exact: their own rounding has then
# moved a y1 or y2 value across a bf16 rounding point, which a kernel
# summing in another order does not follow (one DETR-R50 block,
# stage1_layer3; bottleneck_kernel_bench.bf16_verdict). The card tests hold
# both readings within the bar.
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


def check_k3_bf16(where: str, vs_f32: float, vs_exact: float, f32_vs_exact: float, off: list) -> None:
    """Hold a bf16 K3 reading to ``K3_TOL`` (``bottleneck_kernel_bench.bf16_verdict``):
    fail unless it is within the bar of the plain version with exact sums
    (the bar reading), and of the plain version with float32 sums (the
    diagnostic) wherever those are within the bar of exact. A diagnostic
    over the bar where the float32 sums are themselves over it goes to
    ``off``, which phase 7 prints with that reason."""
    from office_person_detection_vit_torch.bottleneck_kernel_bench import bf16_verdict

    tol = K3_TOL[torch.bfloat16]
    verdict = bf16_verdict(vs_f32, vs_exact, f32_vs_exact, tol)
    check(verdict != "failed", f"K3 {where} bf16: {vs_exact:.3e} from the plain version with exact sums (the bar "
          f"reading), {vs_f32:.3e} with float32 sums (the float32 sums {f32_vs_exact:.3e} from exact); bar {tol:.2e}")
    if verdict == "float32 sums off":
        off.append(f"{where}: bar reading {vs_exact:.3e}; float32-sum diagnostic {vs_f32:.3e}, where the float32 "
                   f"sums are themselves {f32_vs_exact:.3e} from exact")


def load_render_frame():
    spec = importlib.util.spec_from_file_location(
        "synthetic_video", ROOT / "tests" / "helpers" / "synthetic_video.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.render_frame


#: The SASS instructions counted per function: HMMA (mma.sync, the
#: tensor-core product of the sm_80 bodies), HGMMA (wgmma, Hopper's warpgroup
#: product) and UTMALDG (a TMA tile load). HGMMA does not contain "HMMA".
SASS_OPS = ("HMMA", "HGMMA", "UTMALDG")


def sass_counts(build) -> dict:
    """count_ops of the built library's SASS (``cuobjdump``, beside the nvcc
    that built it)."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    check(cuobjdump.exists(), f"{cuobjdump} not found: the tensor-core instructions cannot be read")
    return count_ops(subprocess.run([str(cuobjdump), "-sass", str(build.build_library())], capture_output=True,
                                    text=True, check=True).stdout)


def count_ops(sass: str) -> dict:
    """{function: {op: count}} for each of SASS_OPS, per function of a
    ``cuobjdump -sass`` listing."""
    counts = {}
    op = re.compile(rf"\b({'|'.join(SASS_OPS)})\b")
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None and (m := op.search(line)):
            counts[fn][m.group(1)] += 1
    return counts


def ops_of(counts: dict, name: str) -> dict:
    """The SASS_OPS counts of the one SASS function of a kernel named as the
    attributes entries name it (``base<type,int,...>``). Itanium-mangled
    names carry the base's length and name, then the template arguments: a
    type as one letter (``f`` for float), where the template takes one, and
    each int as ``Li<n>E``."""
    base, args = name.rstrip(">").split("<")
    ints = "".join(f"Li{n}E" for n in args.split(",")[1:])
    mangled = re.compile(rf"{len(base)}{base}I[a-z]?{ints}E")
    found = [n for f, n in counts.items() if mangled.search(f)]
    check(len(found) == 1, f"{name}: {len(found)} functions of its name in the SASS")
    return found[0]


def check_tensor_cores(a: dict, ops: dict, where: str) -> str:
    """A bf16 body runs its products on the tensor cores, a float32 one on
    the CUDA cores: the Hopper bodies (``*_wgmma``) have HGMMA and UTMALDG,
    no HMMA and no spill; the other bf16 bodies HMMA; float32 none of them.
    Returns the counts as a log fragment."""
    name = a["name"]
    if "wgmma" in name:
        check(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0 and ops["HMMA"] == 0 and a["local_bytes"] == 0,
              f"{where}: {name}: HGMMA {ops['HGMMA']}, UTMALDG {ops['UTMALDG']}, HMMA {ops['HMMA']}, spill "
              f"{a['local_bytes']} B (a Hopper body needs wgmma and TMA and may not spill)")
    else:
        bf16 = "bf16" in name.split("<")[1]
        check(bool(ops["HMMA"]) == bf16 and ops["HGMMA"] == 0,
              f"{where}: {name}: {ops['HMMA']} HMMA, {ops['HGMMA']} HGMMA instructions in its SASS")
    return f"HMMA {ops['HMMA']}  HGMMA {ops['HGMMA']}  UTMALDG {ops['UTMALDG']}"


def kernel_resources(ka, kb, build) -> None:
    """Phase 1: each kernel's registers, spills and shared memory
    (cudaFuncGetAttributes; dynamic shared memory from its plan at a main
    path or DETR-R50 shape), and the HMMA instructions in its SASS: every
    bf16 kernel must have them (the Hopper bodies HGMMA and UTMALDG), every
    float32 kernel none."""
    counts = sass_counts(build)
    for a in ka.kernel_attributes():
        base, args = a["name"].split("<")
        if base.startswith("attention_wide"):  # the chunked bodies above head dim 128: CUDA cores in both types
            smem = {"attention_wide": ka.WIDE_FWD_SMEM_BYTES, "attention_wide_bwd_dq": 5 * 64 * 65 * 4 + 64,
                    "attention_wide_bwd_dkdv": (6 * 64 * 65 + 2 * 64) * 4}[base]
            n_hmma = hmma_of_wide(counts, a["name"])
            check(n_hmma == 0, f"{a['name']}: {n_hmma} HMMA instructions in its SASS (a CUDA-core body)")
            log(f"[1] {a['name']:36s} regs {a['regs']:3d}  spill (local) {a['local_bytes']:4d} B  static smem "
                f"{a['static_smem']:6d} B  dynamic smem {smem:6d} B (any head dim)  HMMA in SASS {n_hmma}")
            continue
        dtype = torch.bfloat16 if args.startswith("bf16") else torch.float32
        d = int(args.rstrip(">").split(",")[1])
        if "whole_kv" in base:
            fits = ka.whole_kv_fits(920, d, dtype)
            dyn = f"{ka.whole_kv_plan(920, 920, d, dtype)['smem_bytes']:6d} B at Lk 920" if fits else \
                "none at Lk 920 (K2)"
        elif "wgmma" in base:  # the Hopper bodies: the source's WgLayout, bounded there by a static_assert
            dyn = "WgLayout (source)"
        elif dtype == torch.bfloat16:  # the ring of csrc/attention.cu::Ring: 3 slots of two tiles and the vectors
            dyn = f"{3 * (2 * 64 * d * 2 + (2 if 'dkdv' in base else 1) * 64 * 4):6d} B (ring)"
        elif "dkdv" in base:  # a 64-row tile of Q and g, their lse2 and D
            dyn = f"{2 * 64 * d * 4 + 2 * 64 * 4:6d} B"
        elif "slice" in base:  # a 64-key tile of K and V and its mask bytes
            dyn = f"{2 * 64 * d * 4 + 64:6d} B"
        else:
            dyn = "     0 B"
        ops = check_tensor_cores(a, ops_of(counts, a["name"]), "1")
        log(f"[1] {a['name']:36s} regs {a['regs']:3d}  spill (local) {a['local_bytes']:4d} B  static smem "
            f"{a['static_smem']:6d} B  dynamic smem {dyn}  {ops}")
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
        n_hmma = ops_of(counts, a["name"])["HMMA"]
        check(bool(n_hmma) == (dtype == torch.bfloat16), f"{a['name']}: {n_hmma} HMMA instructions in its SASS")
        rows, tile_w, smem = kb.plan(width, mid, tile_h, dtype, channels)
        check(rows == want_rows, f"{a['name']}: the plan at W {width}, M {mid}, tile_h {tile_h} takes {rows} rows")
        requested = kb.load_library().bottleneck_smem_bytes(int(dtype == torch.bfloat16), rows, tile_h, tile_w, mid)
        check(requested == smem, f"{a['name']}: the launch requests {requested} B of shared memory, the plan {smem}")
        log(f"[1] {a['name']:36s} regs {a['regs']:3d}  spill (local) {a['local_bytes']:4d} B  static smem "
            f"{a['static_smem']:6d} B  dynamic smem {smem:6d} B at W {width}, M {mid}, tile_h {tile_h} "
            f"({tile_h} x {tile_w}, {rows} rows)  HMMA in SASS {n_hmma}")


def float32_card_vs_cpu(ka, cfg, frames: np.ndarray, want_counts: dict, where: str, route: str = "bgr",
                        hw: tuple = (736, 1280)) -> tuple[float, float, float]:
    """The float32 model ``cfg`` (seeded random weights) on the card, TF32
    off, against the same weights on the CPU (the plain attention), on
    ``frames`` at ``hw`` through the ``route`` upload's preprocessing (bgr,
    or i420 from the staging library): the launches must be ``want_counts``
    and the outputs within the repo's DETR bar. -> (max |dlogits|, max
    |dboxes|, the CPU's seconds)."""
    from office_person_detection_vit_torch.device import resolve_device
    from office_person_detection_vit_torch.models.detr import DETR
    from office_person_detection_vit_torch.ops import staging
    from office_person_detection_vit_torch.ops.preprocessing import preprocess_frames, preprocess_frames_i420

    resolve_device("cuda", "float32")  # TF32 off for the float32 comparison
    cpu_model = DETR(cfg)
    cpu_model.init_weights(torch.Generator().manual_seed(0))
    cpu_model.eval()
    gpu_model = DETR(cfg).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.cuda()
    if route == "bgr":
        pixels, mask = preprocess_frames(torch.from_numpy(frames), target_hw=hw)
    else:
        pixels, mask = preprocess_frames_i420(torch.from_numpy(staging.bgr_to_i420(frames)), target_hw=hw)
    ka.reset_launch_counts()
    with torch.inference_mode():
        got = gpu_model(pixels.cuda(), mask.cuda())
        torch.cuda.synchronize()
        counts = dict(ka.launch_counts)
        t = time.perf_counter()
        want = cpu_model(pixels, mask)
        cpu_secs = time.perf_counter() - t
    d_logits = (got["logits"].cpu() - want["logits"]).abs()
    d_boxes = (got["boxes"].cpu() - want["boxes"]).abs().max().item()
    check(counts == want_counts, f"{where}: float32 forward launched {counts}, expected {want_counts}")
    check(bool((d_logits <= LOGITS_ATOL + LOGITS_RTOL * want["logits"].abs()).all()) and d_boxes <= BOXES_ATOL,
          f"{where}: float32 card vs CPU: max|dlogits| {d_logits.max().item():.2e}, max|dboxes| {d_boxes:.2e}")
    return d_logits.max().item(), d_boxes, cpu_secs


def launches(whole_kv: int = 0, flash: int = 0, backward: int = 0) -> dict:
    """The attention kernels' launch counts as ``kernels.attention.launch_counts`` holds them."""
    return {"attention_whole_kv": whole_kv, "attention_flash": flash, "attention_backward": backward}


def expected_launches(ka, tokens: int, dtype, chunks: int) -> dict:
    """K1/K2 launches of DETR's 6 encoder (tokens keys), 6 cross- (tokens
    keys) and 6 decoder self-attention calls (100 keys) per chunk, by the
    dispatch rule; no backward."""
    flash = 6 * (2 * ka.use_flash(tokens, 32, dtype) + ka.use_flash(100, 32, dtype))
    return launches((18 - flash) * chunks, flash * chunks)


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
    off_f32 = []  # bf16 diagnostics over the bar (float32 sums), where those sums are off exact themselves
    for dt, r in runs.items():
        for label, _, tiles in bench.SHAPES:
            e = r["shapes"][label]
            for th in tiles:
                where, rel = f"{label} tile_h {th}", e[f"cuda_th{th}_relerr"]
                if dt == "float32":
                    check(rel <= K3_TOL[torch.float32], f"K3 {where} float32: {rel:.3e} > {K3_TOL[torch.float32]:.1e}")
                else:
                    check_k3_bf16(where, rel, e[f"cuda_th{th}_relerr_exact"], e["plain_relerr_exact"], off_f32)
    for label, (B, H, W, C, M), tiles in bench.SHAPES:
        for th in tiles:
            log(f"[7a] {label} tile_h {th} bf16 plan: {kb.describe_plan(kb.plan_report(B, H, W, C, M, th, torch.bfloat16))}")
    log(f"[7a] bench: {bench_launches} K3 launches, every error within tolerance "
        f"(float32 {K3_TOL[torch.float32]:.0e}, bf16 {K3_TOL[torch.bfloat16]:.2e} relative to max(1,|ref|); bf16 "
        f"against the plain version with exact sums, and with float32 sums as a diagnostic, {len(off_f32)} over "
        f"the bar where the float32 sums are off themselves) on {smi}")

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
            check_k3_bf16(n, errs[n, dtype][1], errs[n, "exact"][1], errs[n, "plain"][1], off_f32)
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
                f"against the plain version with exact sums (the bar reading) "
                f"{max(errs[n, 'exact'][1] for n, _ in blocks):.3e} (bar {K3_TOL[dtype]:.2e}); with float32 sums "
                f"(diagnostic) {worst:.3e}")
    for n, _ in blocks:
        x = io[n][0]
        verdict = bench.bf16_verdict(errs[n, torch.bfloat16][1], errs[n, "exact"][1], errs[n, "plain"][1],
                                     K3_TOL[torch.bfloat16])
        log(f"     {n:13s} {str(tuple(x.shape)):22s} float32 err {errs[n, torch.float32][0]:.3e} "
            f"(rel {errs[n, torch.float32][1]:.3e}); bf16 bar reading (rel, exact sums) {errs[n, 'exact'][1]:.3e}, "
            f"diagnostic (rel, float32 sums) {errs[n, torch.bfloat16][1]:.3e}, float32 sums against exact "
            f"{errs[n, 'plain'][1]:.3e}: {verdict}")
    for u in off_f32:
        log(f"[7] met against exact sums; float32-sum diagnostic over {K3_TOL[torch.bfloat16]:.2e} because those "
            f"sums are off exact themselves, at {u}")

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
        "bf16_float32_sum_diagnostic_over_bar": off_f32,
    }


# ------------------------------------------------------------------- phase 8
# The load of phases 3-4 (8a): a homography that puts a 1280x720 frame on the
# 1878x1369 floormap with some perspective (the reference matrix of phase 6
# sends most of such a frame past its horizon), lens distortion, and four
# floormap zones of which zone_2 overlaps zone_1.
LOAD_H = np.array([[1.2, 0.1, 50.0], [0.05, 1.5, 60.0], [1e-5, 2e-4, 1.0]])
LOAD_LENS = {"enabled": True, "k1": -0.12, "k2": 0.03, "p1": 1.5e-3, "p2": -8e-4, "k3": 0.0,
             "focal_length_x": 1250.0, "focal_length_y": 1250.0, "center_x": 640.0, "center_y": 360.0}
LOAD_ZONES = [
    {"id": "zone_1", "polygon": [[100, 100], [700, 100], [700, 600], [100, 600]], "priority": 2},
    {"id": "zone_2", "polygon": [[600, 450], [1300, 400], [1400, 1000], [550, 950]], "priority": 1},
    {"id": "zone_3", "polygon": [[800, 80], [1420, 100], [1150, 380]], "priority": 3},
    {"id": "zone_4", "polygon": [[100, 700], [520, 700], [520, 1040], [100, 1040]], "priority": 4},
]
#: Floor pixels: float32 against float64 numpy. Zone edges: points closer than
#: this to one are counted apart, since float32 may put them on either side.
FLOOR_TOL, EDGE_PX = 1e-2, 1e-3
STATISTICS_KEYS = {"total_frames", "total_detections", "avg_detections_per_frame", "max_detections_per_frame",
                   "min_detections_per_frame", "confidence", "transfer_format"}


def run_phases(cfg: dict, results: list, out: Path, frames=None, detection=None) -> tuple[dict, dict]:
    """The port's phases into ``out``: detection (when ``detection``, a
    built ``DetectionPhase``, is given), transform and aggregation. Returns
    each phase's wall seconds (host clock, the card synchronised) and the
    phase objects."""
    from office_person_detection_vit_torch.pipeline.phases import AggregationPhase, TransformPhase

    phases = {} if detection is None else {"detection": (detection, (frames, results, out))}
    phases["transform"] = (TransformPhase(cfg), (results, out))
    phases["aggregation"] = (AggregationPhase(cfg), (results, out))
    secs = {}
    for name, (phase, args) in phases.items():
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t = time.perf_counter()
        phase.execute(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
    return secs, {name: phase for name, (phase, _) in phases.items()}


def check_artifacts(out: Path, zone_ids: list, frames: int, session: bool = False,
                    stats_keys: set = STATISTICS_KEYS) -> None:
    """The four artifacts exist, with the keys the JAX package writes
    (``schemas/coordinate_transformations.schema.json`` for the transform's),
    and ``zone_counts.csv`` has a row per frame. ``out`` holds all four, or
    with ``session`` is a session directory with each in its phase's."""
    det_dir, tr_dir, agg_dir = ((out / "02_detection", out / "04_transform", out / "05_aggregation") if session
                                else (out, out, out))
    schema = json.loads((ROOT / "schemas" / "coordinate_transformations.schema.json").read_text())
    det_keys = set(schema["$defs"]["detection"]["properties"])
    dets = json.loads((det_dir / "detections.json").read_text())
    check(set(dets) == {"frames"} and len(dets["frames"]) == frames, "detections.json: frames")
    for f in dets["frames"]:
        check(set(f) == {"frame_number", "timestamp", "detections"}, f"detections.json frame keys {set(f)}")
        for d in f["detections"]:
            check({"bbox", "confidence", "camera_coords"} <= set(d) <= det_keys, f"detection keys {set(d)}")
    stats = json.loads((det_dir / "detection_statistics.json").read_text())
    check(set(stats) == stats_keys, f"detection_statistics.json keys {set(stats)}")
    coords = json.loads((tr_dir / "coordinate_transformations.json").read_text())
    check(set(schema["required"]) <= set(coords) <= set(schema["properties"]), f"transform keys {set(coords)}")
    check(set(coords["transformer_info"]) <= set(schema["properties"]["transformer_info"]["properties"]),
          "transformer_info keys")
    frame_keys = set(schema["$defs"]["frame"]["properties"])
    check(len(coords["frames"]) == frames, "coordinate_transformations.json frames")
    for f in coords["frames"]:
        check(set(f) <= frame_keys, f"transform frame keys {set(f)}")
        for d in f["detections"]:
            check({"bbox", "confidence", "camera_coords", "floor_coords_px", "floor_coords_mm"} <= set(d) <= det_keys,
                  f"transform detection keys {set(d)}")
    rows = (agg_dir / "zone_counts.csv").read_text().splitlines()
    check(rows[0].split(",") == ["timestamp", *zone_ids, "unclassified", "total"], f"zone_counts.csv header {rows[0]}")
    check(len(rows) == frames + 1, f"zone_counts.csv has {len(rows) - 1} rows, expected {frames}")


def seeded_frame_results(n_frames: int, per_frame: int, t_start: datetime, seed: int = 0) -> list:
    """n_frames FrameResults of per_frame seeded detections each, foot points
    anywhere in a 1280x720 frame."""
    from office_person_detection_vit_torch.core.dto import Detection, FrameResult

    rng = np.random.default_rng(seed)
    feet = rng.uniform([10, 40], [1270, 715], (n_frames, per_frame, 2))
    wh = rng.uniform([35, 90], [75, 210], (n_frames, per_frame, 2))
    conf = rng.uniform(0.3, 1.0, (n_frames, per_frame))
    return [FrameResult(f, t_start + timedelta(minutes=5 * f), [
        Detection(bbox=(float(x - w / 2), float(y - h), float(w), float(h)), confidence=float(c))
        for (x, y), (w, h), c in zip(feet[f], wh[f], conf[f])]) for f in range(n_frames)]


def floor64(transformer, method: str, feet: np.ndarray) -> np.ndarray:
    """float64 numpy evaluation of the fitted model the transformer holds
    (its float32 parameters, widened), on float64 foot points."""
    if method == "homography":
        hom = np.c_[feet, np.ones(len(feet))] @ transformer.H.T
        return hom[:, :2] / hom[:, 2:]
    if method == "thin_plate_spline":
        m = transformer.model
        c, w, a, off = (np.asarray(v, np.float64) for v in (m.control, m.w, m.a, m.offset))
        pts = (feet - off) / float(np.float32(m.scale))
        d2 = ((pts[:, None, :] - c[None]) ** 2).sum(-1)
        phi = np.where(d2 > 0, 0.5 * d2 * np.log(np.maximum(d2, 1e-300)), 0.0)
        return phi @ w + np.c_[np.ones(len(pts)), pts] @ a
    p = feet
    und = transformer.undistorter
    if und is not None:  # the fixed-point iteration, in float64
        K, d = und.params.camera_matrix, und.params.dist_coeffs.astype(np.float32).astype(np.float64)
        k1, k2, p1, p2, k3 = d
        xd, yd = (p[:, 0] - K[0, 2]) / K[0, 0], (p[:, 1] - K[1, 2]) / K[1, 1]
        x, y = xd, yd
        for _ in range(und.UNDISTORT_ITERS):
            r2 = x * x + y * y
            radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
            x, y = ((xd - (2 * p1 * x * y + p2 * (r2 + 2 * x * x))) / radial,
                    (yd - (p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)) / radial)
        p = np.stack([x * K[0, 0] + K[0, 2], y * K[1, 1] + K[1, 2]], -1)
    m = transformer.model
    tri, aff, cen = (np.asarray(v, np.float64) for v in (m.triangles, m.affines, m.centroids))
    a = tri[None, :, 0]
    v0, v1, v2 = tri[None, :, 2] - a, tri[None, :, 1] - a, p[:, None] - a
    d00, d01, d11 = (v0 * v0).sum(-1), (v0 * v1).sum(-1), (v1 * v1).sum(-1)
    d20, d21 = (v2 * v0).sum(-1), (v2 * v1).sum(-1)
    den = d00 * d11 - d01 * d01
    u, v = (d11 * d20 - d01 * d21) / den, (d00 * d21 - d01 * d20) / den
    inside = (u >= -1e-7) & (v >= -1e-7) & (u + v <= 1 + 1e-7)
    dist2 = ((p[:, None] - cen[None]) ** 2).sum(-1)
    t = np.argmin(np.where(inside, dist2, dist2 + 1e30), axis=1)
    return np.einsum("nij,nj->ni", aff[t], np.c_[p, np.ones(len(p))])


def zones64(floor: np.ndarray, zones: list, mode: str) -> tuple[np.ndarray, np.ndarray]:
    """float64 even-odd membership (N, Z) under the overlap mode, and
    whether each point lies within EDGE_PX of a zone edge."""
    member = np.zeros((len(floor), len(zones)), bool)
    near = np.zeros(len(floor), bool)
    x, y = floor[:, 0:1], floor[:, 1:2]
    for z, zone in enumerate(zones):
        v0 = np.asarray(zone["polygon"], np.float64)
        v1 = np.roll(v0, -1, axis=0)
        cross = ((v0[:, 1] > y) != (v1[:, 1] > y)) & (
            x < v0[:, 0] + (y - v0[:, 1]) * (v1[:, 0] - v0[:, 0]) / (v1[:, 1] - v0[:, 1] + (v1[:, 1] == v0[:, 1])))
        member[:, z] = cross.sum(1) % 2 == 1
        e = v1 - v0
        s = np.clip(((x - v0[:, 0]) * e[:, 0] + (y - v0[:, 1]) * e[:, 1]) / (e ** 2).sum(1), 0, 1)
        near |= (np.hypot(x - v0[:, 0] - s * e[:, 0], y - v0[:, 1] - s * e[:, 1]) < EDGE_PX).any(1)
    if mode == "priority":
        prio = np.asarray([zone["priority"] for zone in zones])
        best = np.argmin(np.where(member, prio, 2**30), axis=1)
        member = member.any(1, keepdims=True) & (np.arange(len(zones))[None] == best[:, None])
    return member, near


def load_phase(device: str, smi: str, t_start: datetime, n_frames: int = 288, per_frame: int = 50) -> None:
    """8a, the load: n_frames x per_frame seeded detections through the
    transform and aggregation phases with homography, PWA and TPS (each
    fitted on a 7x7 grid made from LOAD_H, lens undistortion on), overlap
    modes all and priority, held against float64 numpy."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        gx, gy = np.meshgrid(np.linspace(0, 1280, 7), np.linspace(0, 720, 7))
        cam = np.stack([gx.ravel(), gy.ravel()], 1)
        hom = np.c_[cam, np.ones(len(cam))] @ LOAD_H.T
        corr = tmp / "correspondences.json"
        corr.write_text(json.dumps({"camera": cam.tolist(), "floormap": (hom[:, :2] / hom[:, 2:]).tolist()}))
        for method in ("homography", "piecewise_affine", "thin_plate_spline"):
            for mode in ("all", "priority"):
                cfg = {"detection.device": device, "transform.method": method, "homography.matrix": LOAD_H.tolist(),
                       "calibration.correspondence_file": str(corr), "zones": LOAD_ZONES, "zones_overlap_mode": mode,
                       **{f"transform.lens_distortion.{k}": v for k, v in LOAD_LENS.items()}}
                results = seeded_frame_results(n_frames, per_frame, t_start)
                out = tmp / f"{method}_{mode}"
                secs, phases = run_phases(cfg, results, out)
                tphase = phases["transform"]
                dets = [d for fr in results for d in fr.detections]
                feet = np.asarray([d.foot_point for d in dets], np.float32).astype(np.float64)
                got = np.asarray([d.floor_coords_px for d in dets])
                want = floor64(tphase.transformer, method, feet)
                gap = float(np.abs(got - want).max())
                check(gap < FLOOR_TOL, f"8a {method}: floor points {gap:.3e} px from float64 (tol {FLOOR_TOL})")
                member, near = zones64(want, LOAD_ZONES, mode)
                ids = [z["id"] for z in LOAD_ZONES]
                port = np.asarray([[z in d.zone_ids for z in ids] for d in dets])
                differ = (port != member).any(1)
                check(not (differ & ~near).any(), f"8a {method} {mode}: {int((differ & ~near).sum())} detections away "
                      f"from every zone edge are zoned differently from float64")
                # zone_counts.csv against the float64 membership (the port's
                # own at the few points within EDGE_PX of an edge)
                member = np.where(near[:, None], port, member)
                rows = list(csv.reader((out / "zone_counts.csv").open()))[1:]
                check(len(rows) == n_frames, f"8a {method} {mode}: {len(rows)} rows of zone_counts.csv")
                csv_counts = np.asarray([[int(v) for v in r[1:1 + len(ids)]] for r in rows])
                want_counts = member.reshape(n_frames, per_frame, len(ids)).sum(1)
                check(np.array_equal(csv_counts, want_counts), f"8a {method} {mode}: zone counts differ from float64")
                uncls = np.asarray([int(r[1 + len(ids)]) for r in rows])
                check(np.array_equal(uncls, (~member.any(1)).reshape(n_frames, per_frame).sum(1)),
                      f"8a {method} {mode}: unclassified counts differ from float64")
                lens = "undistorted" if method == "piecewise_affine" and tphase.undistorter is not None else "no lens"
                log(f"[8a] load {method:17s} {mode:8s} ({lens}): {len(dets)} foot points, max floor gap {gap:.2e} px "
                    f"from float64; {int(near.sum())} within {EDGE_PX} px of a zone edge; counts "
                    f"{want_counts.sum(0).tolist()} (+{int(uncls.sum())} unclassified) equal; transform "
                    f"{secs['transform']:.3f} s, aggregation {secs['aggregation']:.3f} s (host clock) on {smi}")


def slice_frames(render_frame, t_start: datetime, n: int = 288) -> tuple[list, list]:
    """8a's load: n rendered 720p frames at 5-minute intervals, one person
    each, and their timestamps."""
    stamps = [t_start + timedelta(minutes=5 * i) for i in range(n)]
    frames = [render_frame(ts, people=[(80 + 37 * i % 1100, 120 + 53 * i % 400, i % 6)], seed=100 + i)
              for i, ts in enumerate(stamps)]
    return frames, stamps


def full_width_phase(ka, smi: str, render_frame, t_start: datetime, H: np.ndarray, zones: list) -> dict:
    """8a: DETR-R50 bf16 at 736x1280, batch 8, seeded random weights, over
    288 rendered 720p frames (a day at 5-minute intervals), through the
    port's DetectionPhase, TransformPhase (phase 6's homography and zones)
    and AggregationPhase. Returns the attention launches of that run, and
    the frames and their timestamps (phase 11c's load)."""
    from office_person_detection_vit_torch.core.dto import FrameResult
    from office_person_detection_vit_torch.pipeline.phases import DetectionPhase

    frames, stamps = slice_frames(render_frame, t_start)
    n = len(frames)
    cfg = {"detection.model_size": "full", "detection.dtype": "bfloat16", "detection.device": "cuda",
           "detection.batch_size": 8, "detection.input_height": 736, "detection.input_width": 1280,
           "detection.confidence_threshold": 0.0, "detection.nms_threshold": 0.4,
           "transform.method": "homography", "homography.matrix": H.tolist(), "zones": zones}
    detection = DetectionPhase(cfg)
    detection.initialize()
    detection.detector.detect_batch(np.stack(frames[:8]))  # warm-up: one chunk
    results = [FrameResult(i, ts) for i, ts in enumerate(stamps)]
    with tempfile.TemporaryDirectory() as tmp:
        ka.reset_launch_counts()
        secs, _ = run_phases(cfg, results, Path(tmp), frames, detection)
        counts = dict(ka.launch_counts)
        failed = detection.detector.last_failed_chunks
        check_artifacts(Path(tmp), [z["id"] for z in zones], n)
    # detect_batch isolates a chunk that raises into all-invalid results; with
    # random weights those look like a clean run of 0 detections.
    check(failed == 0, f"8a: {failed} of {n // 8} chunks raised in the detection phase")
    want = expected_launches(ka, 920, torch.bfloat16, n // 8)
    check(counts == want and counts["attention_flash"] == 18 * (n // 8),
          f"8a: the detection phase launched {counts}, expected {want} (18 K2 a chunk x {n // 8})")
    found = sum(len(r.detections) for r in results)
    zoned = sum(bool(d.zone_ids) for r in results for d in r.detections)
    loop = detection.detector.last_inference_time
    # Random weights may leave few detections; the features' width is
    # d_model (256) whatever their number.
    dets, feats = detection.detector.detect_with_features(frames[0])
    check(feats.shape == (len(dets), 256), f"8a: features {feats.shape} for {len(dets)} detections")
    check(bool(np.all(np.abs(np.linalg.norm(feats, axis=1) - 1) < 1e-3)), "8a: features are not L2-normalised")
    log(f"[8a] full width: {n} frames, DETR-R50 bf16 736x1280 batch 8 -> DetectionPhase -> TransformPhase "
        f"(homography) -> AggregationPhase: launches {counts} over {n // 8} chunks (18 K2 a chunk, none raised); "
        f"{found} detections (confidence 0.0), {zoned} in a zone; the four artifacts carry the JAX keys and "
        f"zone_counts.csv {n} rows; detect_with_features {feats.shape} L2-normalised")
    log(f"[8a] wall time (host clock, card synchronised): detection phase {secs['detection']:.3f} s "
        f"({n / secs['detection']:.2f} frames/s with its artifacts; the chunk loop {loop:.3f} s, "
        f"{n / loop:.2f} frames/s), transform {secs['transform']:.3f} s, aggregation {secs['aggregation']:.3f} s, "
        f"on {smi}")
    detection.cleanup()
    return counts, frames, stamps


def without_timestamp(frame: np.ndarray, seed: int) -> np.ndarray:
    """The rendered frame with its burned-in timestamp band (x >= 0.70 W,
    y < 0.105 H) repainted in the renderer's background, 40 plus noise in
    [0, 12)."""
    h, w = frame.shape[:2]
    y1, x0 = int(np.ceil(0.105 * h)), int(0.70 * w)
    out = frame.copy()
    out[:y1, x0:] = 40 + np.random.default_rng(seed).integers(0, 12, out[:y1, x0:].shape, np.uint8)
    return out


def trained_phase(ka, smi: str, render_frame, t_start: datetime) -> dict:
    """8b: the committed DETR-small checkpoint at 224x384 in float32 over the
    frame of phase 5 and three more, one person each, inside a known
    camera-pixel zone (identity homography); zone_counts.csv must count each
    frame's person in their zone and nothing else. The frames carry no
    timestamp: the checkpoint fires at 0.20-0.22 on the text as some OpenCV
    builds draw it, and this check is of the people. Then its features,
    attention map, and detect_batch's launches after the attention map.
    Returns the attention launches of the phases."""
    from office_person_detection_vit_torch.core.dto import FrameResult
    from office_person_detection_vit_torch.pipeline.phases import DetectionPhase

    people = [((500, 350, 2), 4, "zone_sw"), ((150, 200, 0), 5, "zone_nw"), ((900, 150, 1), 6, "zone_ne"),
              ((1000, 450, 3), 7, "zone_se")]
    stamps = [t_start + timedelta(minutes=5 * i) for i in range(len(people))]
    frames = [without_timestamp(render_frame(ts, people=[p], seed=seed), seed)
              for ts, (p, seed, _) in zip(stamps, people)]
    quads, zones = HOUR_QUADS, hour_zones()
    cfg = {"detection.model_size": "small", "detection.score_mode": "sigmoid",
           "detection.checkpoint_path": str(ROOT / "docs" / "artifacts" / "detr_small_weights.npz"),
           "detection.device": "cuda", "detection.dtype": "float32", "detection.input_height": 224,
           "detection.input_width": 384, "detection.confidence_threshold": 0.2, "detection.nms_threshold": 0.3,
           "detection.batch_size": 1, "transform.method": "homography", "homography.matrix": np.eye(3).tolist(),
           "zones": zones}
    detection = DetectionPhase(cfg)
    detection.initialize()
    results = [FrameResult(i, ts) for i, ts in enumerate(stamps)]
    with tempfile.TemporaryDirectory() as tmp:
        ka.reset_launch_counts()
        run_phases(cfg, results, Path(tmp), frames, detection)
        counts = dict(ka.launch_counts)
        failed = detection.detector.last_failed_chunks
        check_artifacts(Path(tmp), list(quads), len(frames))
        rows = list(csv.reader((Path(tmp) / "zone_counts.csv").open()))
    want = launches(whole_kv=9 * len(frames))
    check(counts == want, f"8b: the detection phase launched {counts}, expected {want} (9 K1 a frame)")
    check(failed == 0, f"8b: {failed} of {len(frames)} chunks raised in the detection phase")
    for row, result, ((px, py, _), _, zone) in zip(rows[1:], results, people):
        # one detection, at the drawn person (GT box (px, py - 26, 50, 156)),
        # in its zone
        dets = [(d.bbox, d.zone_ids) for d in result.detections]
        d = result.detections[0] if len(dets) == 1 else None
        check(d is not None and abs(d.center[0] - px - 25) < 60 and abs(d.center[1] - py + 26 - 78) < 60
              and d.zone_ids == [zone], f"8b: {result.timestamp_str}: detections {dets}, expected one person in {zone}")
        got = dict(zip(rows[0][1:], row[1:]))
        want_row = {z: str(int(z == zone)) for z in quads} | {"unclassified": "0", "total": "1"}
        check({k: got[k] for k in want_row} == want_row,
              f"8b: {result.timestamp_str}: zone_counts.csv {got}, expected one person in {zone}")
    det = detection.detector
    dets, feats = det.detect_with_features(frames[0])
    d_model = det.detr_config.d_model
    check(len(dets) >= 1 and feats.shape == (len(dets), d_model), f"8b: features {feats.shape} for {len(dets)}")
    check(bool(np.all(np.abs(np.linalg.norm(feats, axis=1) - 1) < 1e-5)), "8b: features are not L2-normalised")
    amap = det.get_attention_map(frames[0])
    check(amap.shape == det.feature_hw and bool(np.isfinite(amap).all()), f"8b: attention map {amap.shape}")
    ka.reset_launch_counts()
    det.detect_batch(np.stack(frames))
    after = dict(ka.launch_counts)
    check(after == counts, f"8b: detect_batch launched {after} after the attention map, {counts} before it")
    log(f"[8b] DETR-small checkpoint 224x384 float32 through the phases: launches {counts} (9 K1 a frame); "
        f"zone_counts.csv places each of the {len(frames)} people in their zone "
        f"({', '.join(z for _, _, z in people)}) and counts nothing else; "
        f"detect_with_features {feats.shape} L2-normalised (d_model "
        f"{d_model}); attention map {amap.shape} finite, peak/mean {amap.max() / amap.mean():.2f}; detect_batch "
        f"launches after it {after}, unchanged")
    detection.cleanup()
    return counts


# ------------------------------------------------------------------- phase 9
# The videos of phase 9: timelapses at 30 fps and ratio 313 (a wall-clock
# second is 1/313 video second), 720p, written by write_video. The scan of
# Phase 1 reads every 6th frame (tolerance 60 wall seconds is 0.19 video
# seconds, 5.75 frames, rounded), and the targets run from the first read
# timestamp to the last: a video has frames until the scan reaches the end of
# its span, so that the last target is one of them.
FPS, RATIO, TOLERANCE_S, SCAN_STRIDE = 30, 313.0, 60, 6
# 9a's span: 2 hours since phase 14 (Phase 1's OCR of the scanned frames
# takes most of 9a: 8 hours took 294 s of it on an H100 machine, 4 hours
# 128.3 s; the script with [14] must stay well inside its 1200 s).
DAY_START, DAY_HOURS = datetime(2025, 1, 20, 8, 0, 0), 2
HOUR_START = datetime(2025, 1, 20, 9, 0, 0)
EXTRACTION_HEADER = ["frame_number", "timestamp", "target_timestamp", "confidence", "time_error_seconds",
                     "frame_path"]
PHASES = ["01_extraction", "02_detection", "03_tracking", "04_transform", "05_aggregation", "06_visualization"]


def video_frames(span_hours: float) -> int:
    """Frames of a video whose scan (every SCAN_STRIDE-th frame) reaches
    ``span_hours`` of wall clock."""
    last = math.ceil(span_hours * 3600 * FPS / RATIO / SCAN_STRIDE) * SCAN_STRIDE
    return last + 1


def burned_in(start: datetime, frame_number: int) -> datetime:
    """The wall-clock time write_video draws on a frame, to the second."""
    return (start + timedelta(seconds=frame_number / FPS * RATIO)).replace(microsecond=0)


def day_people(i: int) -> list:
    """Three people walking across the office, wrapping at the edges."""
    return [(80 + (7 * i + 380 * k) % 1100, 140 + 190 * k, k) for k in range(3)]


def hour_people(i: int) -> list:
    """Two people at known places, one in the west half, one in the east."""
    return [(150 + (5 * i) % 400, 200, 1), (760 + (3 * i) % 400, 420, 2)]


#: Phase 9b's zones of the one-hour video: its four quadrants.
HOUR_QUADS = {"zone_nw": (0, 0), "zone_ne": (640, 0), "zone_sw": (0, 360), "zone_se": (640, 360)}


def hour_zones() -> list:
    return [{"id": z, "polygon": [[x, y], [x + 640, y], [x + 640, y + 360], [x, y + 360]], "priority": i + 1}
            for i, (z, (x, y)) in enumerate(HOUR_QUADS.items())]


def write_videos(out_dir: str) -> None:
    """Phase 9's two videos (a day and an hour), in a child process."""
    spec = importlib.util.spec_from_file_location("synthetic_video", ROOT / "tests" / "helpers" / "synthetic_video.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = Path(out_dir)
    mod.write_video(out / "hour.mp4", num_frames=video_frames(1), start_time=HOUR_START, people_fn=hour_people)
    mod.write_video(out / "day.mp4", num_frames=video_frames(DAY_HOURS), start_time=DAY_START, people_fn=day_people)


def start_video_writer(out_dir: Path) -> subprocess.Popen:
    code = f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; chip_smoke.write_videos({str(out_dir)!r})"
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def flow_config(video: Path, out: Path, detection: dict, homography, zones: list) -> dict:
    """A config as a user writes one: the video, the detector, the floor
    transform and zones, the outputs: the floormaps and the three charts of
    phase 5 (drawn without matplotlib, which the card machine lacks)."""
    return {
        "video": {"input_path": str(video), "fps": FPS, "frame_interval_minutes": 5,
                  "tolerance_seconds": TOLERANCE_S, "time_compression_ratio": RATIO},
        "detection": detection,
        "transform": {"method": "homography"},
        "homography": {"matrix": np.asarray(homography).tolist()},
        "zones": zones,
        "output": {"directory": str(out), "save_floormap_images": True},
        # max_frames above the scan's frame count, so the stride stays within
        # the tolerance (frame_extraction_pipeline widens it to fit the budget)
        "timestamp": {"extraction_mode": "auto_targets", "auto_targets": {"max_frames": 800}},
    }


class FlowProbe:
    """What a run of ``main`` did below its entry point: each detect_batch's
    failed chunks, and every frame decoded from the video or reloaded from
    disk for detection. Installed around the port's classes for phase 9."""

    def __init__(self):
        from office_person_detection_vit_torch.detection.detector import DETRDetector
        from office_person_detection_vit_torch.detection.ssd_detector import SSDDetector
        from office_person_detection_vit_torch.pipeline.orchestrator import PipelineOrchestrator
        from office_person_detection_vit_torch.video.video_processor import VideoProcessor

        self.failed_chunks, self.chunks, self.decoded, self.reloads = [], 0, 0, 0
        probe = self
        get_frame, iter_frames = VideoProcessor.get_frame, VideoProcessor.iter_frames
        prepare = PipelineOrchestrator.prepare_frames_for_detection

        def counted(detect):
            def detect_batch(det, frames):
                out = detect(det, frames)
                probe.failed_chunks.append(det.last_failed_chunks)
                probe.chunks += math.ceil(len(frames) / det.batch_size)
                return out
            return detect_batch

        def counted_get_frame(vp, n):
            probe.decoded += 1
            return get_frame(vp, n)

        def counted_iter_frames(vp, numbers):
            for item in iter_frames(vp, numbers):
                probe.decoded += 1
                yield item

        def counted_prepare(orch):
            probe.reloads += 1
            return prepare(orch)

        for cls in (DETRDetector, SSDDetector):  # SSDDetector's is YOLODetector's too
            cls.detect_batch = counted(cls.detect_batch)
        VideoProcessor.get_frame, VideoProcessor.iter_frames = counted_get_frame, counted_iter_frames
        PipelineOrchestrator.prepare_frames_for_detection = counted_prepare

    def reset(self):
        self.failed_chunks, self.chunks, self.decoded, self.reloads = [], 0, 0, 0


def run_main(ka, probe: FlowProbe, cfg: dict, path: Path, *flags: str) -> tuple[int, dict, float, Path]:
    """``main.main`` on a YAML config: exit code, attention launches (counts
    set to 0 just before), host seconds, and the session directory. main's
    console log goes to a file beside the config, whose end is printed when
    main fails."""
    import logging

    import yaml

    from office_person_detection_vit_torch.main import main as port_main

    path.write_text(yaml.safe_dump(cfg))
    probe.reset()
    ka.reset_launch_counts()
    with path.with_suffix(".log").open("w") as console, contextlib.redirect_stdout(console):
        t = time.perf_counter()
        rc = port_main(["--config", str(path), *flags])
        secs = time.perf_counter() - t
        root = logging.getLogger()
        for handler in list(root.handlers):  # main's handlers write to the file and the session
            root.removeHandler(handler)
            handler.close()
    counts = dict(ka.launch_counts)
    if rc != 0:
        log("\n".join(path.with_suffix(".log").read_text().splitlines()[-60:]))
    out = Path(cfg["output"]["directory"])
    sessions = sorted(p for p in out.iterdir() if p.is_dir() and not p.is_symlink())
    check(len(sessions) == 1, f"9: {len(sessions)} sessions under {out}")
    return rc, counts, secs, sessions[0]


def extraction_rows(session: Path) -> list:
    rows = list(csv.reader((session / "01_extraction" / "extraction_results.csv").open()))
    check(rows[0] == EXTRACTION_HEADER, f"9: extraction_results.csv header {rows[0]}")
    return [r[:-1] + [Path(r[-1]).name] for r in rows[1:]]


def check_extraction(session: Path, start: datetime, hours: float, where: str) -> list:
    """Every 5-minute target of the span extracted once, within the
    tolerance, with the timestamp the video burned into that frame."""
    rows = extraction_rows(session)
    targets = [start + timedelta(minutes=5 * i) for i in range(int(hours * 12) + 1)]
    got = {datetime.fromisoformat(r[2]): r for r in rows}
    missing = [t for t in targets if t not in got]
    check(not missing and len(rows) == len(targets),
          f"{where}: {len(rows)} frames extracted, {len(targets)} targets; missing {[str(t) for t in missing]} "
          f"(a target without a scanned frame within {TOLERANCE_S} s, or past the last read timestamp)")
    for target, r in got.items():
        fn, ts = int(r[0]), datetime.fromisoformat(r[1])
        check(ts == burned_in(start, fn), f"{where}: frame {fn} read {ts}, the video burned in {burned_in(start, fn)}")
        check(abs((ts - target).total_seconds()) <= TOLERANCE_S and float(r[4]) <= TOLERANCE_S,
              f"{where}: frame {fn} at {ts} is {r[4]} s from its target {target}")
    return rows


def check_session(session: Path, zone_ids: list, frames: int, where: str, stats_keys: set = STATISTICS_KEYS) -> dict:
    """summary.json completed, every phase's checkpoint (tracking skipped:
    phase 9's configs leave it off),
    the artifacts with the JAX keys and the repo's JSON schemas, and a
    floormap PNG a frame. Returns the summary."""
    sys.path.insert(0, str(ROOT / "tools"))
    from validate_artifacts import validate_session

    summary = json.loads((session / "summary.json").read_text())
    check(summary["status"] == "completed", f"{where}: summary status {summary['status']}")
    check(summary["statistics"]["frames_extracted"] == frames, f"{where}: summary statistics {summary['statistics']}")
    phases = json.loads((session / "pipeline_checkpoint.json").read_text())["phases"]
    want = {p: ("skipped" if p == "03_tracking" else "completed") for p in PHASES}
    check({p: e["status"] for p, e in phases.items()} == want, f"{where}: checkpoints {phases}")
    check_artifacts(session, zone_ids, frames, session=True, stats_keys=stats_keys)
    with contextlib.redirect_stdout(io.StringIO()):  # it prints a line an artifact
        errors = validate_session(session, ROOT / "schemas")
    check(not errors, f"{where}: schema errors {errors}")
    floormaps = list((session / "06_visualization" / "floormaps").glob("floormap_*.png"))
    check(len(floormaps) == frames, f"{where}: {len(floormaps)} floormap PNGs for {frames} frames")
    import cv2

    for chart in CHARTS:
        img = cv2.imread(str(session / "06_visualization" / chart))
        check(img is not None and img.size > 0 and img.std() > 0, f"{where}: chart {chart} missing or blank")
    return summary


#: Phase 5's charts, drawn with OpenCV (ROADMAP C.5).
CHARTS = ("zone_time_series.png", "zone_statistics.png", "zone_heatmap.png")


def phase_seconds(summary: dict) -> str:
    return ", ".join(f"{k} {v['total_time']:.3f} s" for k, v in summary["performance"].items())


#: Chunks the ``auto`` race runs on the first batch: each format once to
#: warm it, then 3 interleaved rounds (DETRDetector._autotune_transfer).
RACE_CHUNKS = 3 + 3 * 3


def day_flow(ka, probe, smi: str, videos: Path, tmp: Path, H: np.ndarray, zones: list) -> dict:
    """9a: the day video (DAY_HOURS) through main, DETR-R50 bf16 at full
    width, with the shipped config.yaml's ``detection.transfer_format:
    auto`` (the race's winner in detection_statistics.json, whose keys
    check_session holds to the JAX phase's)."""
    import yaml

    from office_person_detection_vit_torch.detection.detector import TRANSFER_FORMATS

    shipped = yaml.safe_load((ROOT / "config.yaml").read_text())["detection"]["transfer_format"]
    detection = {"model": "detr", "model_size": "full", "dtype": "bfloat16", "device": "cuda", "batch_size": 8,
                 "input_height": 736, "input_width": 1280, "checkpoint_path": None, "confidence_threshold": 0.0,
                 "nms_threshold": 0.4, "transfer_format": shipped}
    cfg = flow_config(videos / "day.mp4", tmp / "day", detection, H, zones)
    rc, counts, secs, session = run_main(ka, probe, cfg, tmp / "day.yaml")
    check(rc == 0, f"9a: main exited {rc}")
    n = DAY_HOURS * 12 + 1
    check_extraction(session, DAY_START, DAY_HOURS, "9a")
    summary = check_session(session, [z["id"] for z in zones], n, "9a")
    chunks = math.ceil(n / 8)
    check(probe.chunks == chunks and sum(probe.failed_chunks) == 0,
          f"9a: {sum(probe.failed_chunks)} of {probe.chunks} chunks raised (expected {chunks} chunks)")
    raced = RACE_CHUNKS if shipped == "auto" else 0
    want = expected_launches(ka, 920, torch.bfloat16, chunks + raced)
    check(counts == want and counts["attention_flash"] == 18 * (chunks + raced) and counts["attention_whole_kv"] == 0,
          f"9a: main launched {counts}, expected {want} (18 K2 a chunk x {chunks} and {raced} raced, no K1)")
    pick = json.loads((session / "02_detection" / "detection_statistics.json").read_text())["transfer_format"]
    check(pick in TRANSFER_FORMATS, f"9a: detection.transfer_format {shipped!r} ran {pick!r}")
    scanned = math.ceil(video_frames(DAY_HOURS) / SCAN_STRIDE)
    span = f"{DAY_START:%H:%M}-{DAY_START + timedelta(hours=DAY_HOURS):%H:%M}"
    log(f"[9a] main, {video_frames(DAY_HOURS)}-frame 720p video {span} ({scanned} frames scanned and OCR'd, "
        f"stride {SCAN_STRIDE}): {n} frames extracted, each at its 5-minute target within {TOLERANCE_S} s and with "
        f"the timestamp burned in; DETR-R50 bf16 736x1280 batch 8, transfer_format {shipped}: launches {counts} "
        f"over {chunks} chunks and {raced} raced (18 K2 a chunk, none raised; the race kept {pick}); checkpoints "
        f"01-06 (03_tracking skipped), the artifacts with the JAX keys and schemas, {n} floormap PNGs and the three charts ({', '.join(CHARTS)}); "
        f"{summary['statistics']['total_detections']} detections (random weights)")
    log(f"[9a] phase seconds (summary.json, the card synchronised at each phase's end): {phase_seconds(summary)}; "
        f"main {secs:.3f} s in all (host clock) on {smi}")
    return counts


def matched(card: list, cpu: list) -> tuple[list, list]:
    """Card and CPU detections of a frame paired one to one (nearest box
    centre); the ones left over on either side."""
    pairs, rest = [], list(cpu)
    for d in card:
        j = min(range(len(rest)), key=lambda k: np.hypot(*(np.subtract(box_centre(d), box_centre(rest[k])))),
                default=None)
        if j is not None and np.hypot(*(np.subtract(box_centre(d), box_centre(rest[j])))) < 10:
            pairs.append((d, rest.pop(j)))
    left = [d for d in card if all(d is not a for a, _ in pairs)] + rest
    return pairs, left


def box_centre(d: dict) -> tuple:
    b = d["bbox"]
    return b["x"] + b["width"] / 2, b["y"] + b["height"] / 2


def hour_flow(ka, probe, smi: str, videos: Path, tmp: Path) -> tuple[dict, Path, Path]:
    """9b: the committed DETR-small checkpoint on the one-hour video, on the
    card and on the CPU, held to each other."""
    quads = {"zone_nw": (0, 0), "zone_ne": (640, 0), "zone_sw": (0, 360), "zone_se": (640, 360)}
    zones = [{"id": z, "polygon": [[x, y], [x + 640, y], [x + 640, y + 360], [x, y + 360]], "priority": i + 1}
             for i, (z, (x, y)) in enumerate(quads.items())]
    detection = {"model_size": "small", "score_mode": "sigmoid", "dtype": "float32", "input_height": 224,
                 "input_width": 384, "confidence_threshold": 0.2, "nms_threshold": 0.3, "batch_size": 1,
                 "checkpoint_path": str(ROOT / "docs" / "artifacts" / "detr_small_weights.npz")}
    runs = {}
    n = 13
    for device in ("cuda", "cpu"):
        cfg = flow_config(videos / "hour.mp4", tmp / f"hour_{device}", dict(detection, device=device), np.eye(3), zones)
        rc, counts, secs, session = run_main(ka, probe, cfg, tmp / f"hour_{device}.yaml")
        check(rc == 0, f"9b {device}: main exited {rc}")
        check_extraction(session, HOUR_START, 1, f"9b {device}")
        summary = check_session(session, list(quads), n, f"9b {device}")
        check(sum(probe.failed_chunks) == 0, f"9b {device}: {sum(probe.failed_chunks)} chunks raised")
        runs[device] = (counts, secs, session, summary, cfg)
    (counts, secs, card, card_summary, card_cfg), (cpu_counts, cpu_secs, cpu, cpu_summary, _) = runs["cuda"], runs["cpu"]
    want = launches(whole_kv=9 * n)
    check(counts == want, f"9b: the card run launched {counts}, expected {want} (9 K1 a frame)")
    check(cpu_counts == launches(), f"9b: the CPU run launched {cpu_counts}")
    check(extraction_rows(card) == extraction_rows(cpu), "9b: extraction_results.csv differs between card and CPU")
    thr = detection["confidence_threshold"]
    dets = {k: json.loads((s / "04_transform" / "coordinate_transformations.json").read_text())["frames"]
            for k, s in (("card", card), ("cpu", cpu))}
    near, n_pairs, worst = set(), 0, {"conf": 0.0, "box": 0.0, "floor": 0.0}
    for fc, fp in zip(dets["card"], dets["cpu"]):
        check(fc["frame_number"] == fp["frame_number"], "9b: frames differ")
        pairs, left = matched(fc["detections"], fp["detections"])
        for d in left:
            check(abs(d["confidence"] - thr) <= 1e-3, f"9b: frame {fc['frame_number']}: unmatched detection {d}")
            near.add(fc["timestamp"])
        for a, b in pairs:
            n_pairs += 1
            worst["conf"] = max(worst["conf"], abs(a["confidence"] - b["confidence"]))
            worst["box"] = max(worst["box"], *(abs(a["bbox"][k] - b["bbox"][k]) / (1280 if k in ("x", "width") else 720)
                                               for k in a["bbox"]))
            worst["floor"] = max(worst["floor"], *(abs(a["floor_coords_px"][k] - b["floor_coords_px"][k]) for k in "xy"))
            if min(a["confidence"], b["confidence"]) - thr <= 1e-3:
                near.add(fc["timestamp"])
    check(worst["conf"] <= 1e-3 and worst["box"] <= 1e-3 and worst["floor"] <= FLOOR_TOL,
          f"9b: card against CPU {worst} (confidence 1e-3, box 1e-3 of the frame, floor {FLOOR_TOL} px)")
    check(n_pairs >= n, f"9b: {n_pairs} detections matched over {n} frames")
    rows = {k: list(csv.reader((s / "05_aggregation" / "zone_counts.csv").open())) for k, s in (("card", card), ("cpu", cpu))}
    differ = [rc[0] for rc, rp in zip(rows["card"], rows["cpu"]) if rc != rp]
    check(len(rows["card"]) == len(rows["cpu"]) == n + 1 and all(t in near for t in differ),
          f"9b: zone_counts.csv rows {differ} differ between card and CPU, away from the threshold")
    log(f"[9b] main, DETR-small checkpoint 224x384 float32 on the {video_frames(1)}-frame one-hour video, card and "
        f"CPU: {n} frames extracted, extraction_results.csv identical; {n_pairs} detections matched one to one: "
        f"confidence {worst['conf']:.2e}, box {worst['box']:.2e} of the frame, floor {worst['floor']:.2e} px; "
        f"zone_counts.csv: {len(differ)} rows differ (only a row with a detection within 1e-3 of the threshold may); "
        f"{len(near)} frames hold a detection within 1e-3 of the threshold; card launches {counts} (9 K1 a frame)")
    log(f"[9b] phase seconds, card: {phase_seconds(card_summary)}; main {secs:.3f} s. CPU: "
        f"{phase_seconds(cpu_summary)}; main {cpu_secs:.3f} s (host clock) on {smi}")
    return counts, card, card_cfg


def resume_flow(ka, probe, card: Path, cfg: dict, tmp: Path) -> None:
    """9c: main --resume on 9b's card session: phases 1-4 (01 to 04) and
    visualization reloaded, no kernel launch, no frame decoded, the same
    zone_counts.csv."""
    before = (card / "05_aggregation" / "zone_counts.csv").read_bytes()
    rc, counts, secs, session = run_main(ka, probe, cfg, tmp / "hour_resume.yaml", "--resume", str(card))
    check(rc == 0 and session == card, f"9c: main --resume exited {rc}")
    summary = json.loads((card / "summary.json").read_text())
    ran = set(summary["performance"])
    check(summary["status"] == "completed" and ran == {"05_aggregation"},
          f"9c: resumed run timed {sorted(ran)}, expected only 05_aggregation (01-04 and 06 reloaded)")
    check(sum(counts.values()) == 0 and probe.decoded == 0 and probe.reloads == 0 and probe.chunks == 0,
          f"9c: resumed run launched {counts}, decoded {probe.decoded} frames, reloaded frames {probe.reloads} times, "
          f"detected {probe.chunks} chunks")
    check((card / "05_aggregation" / "zone_counts.csv").read_bytes() == before, "9c: zone_counts.csv changed on resume")
    log(f"[9c] main --resume: phases 01-04 and 06 skipped (only 05_aggregation ran, {phase_seconds(summary)}); "
        f"launches {counts}, 0 frames decoded; zone_counts.csv byte-identical; main {secs:.3f} s")


def kept_session(videos: Path, which: str) -> Path:
    """The session that flow_phase kept under ``videos/<which>_session/``."""
    (session,) = (videos / f"{which}_session").iterdir()
    return session


def flow_phase(ka, smi: str, writer: subprocess.Popen, videos: Path, H: np.ndarray,
               zones: list) -> tuple[dict, dict, FlowProbe]:
    """Phase 9: the videos, then 9a, 9b and 9c. Returns the launches of 9a
    and of 9b's card run, and the probe installed around the port's classes
    (phase 11b runs main under it too). 9a's session is kept under
    ``videos/day_session/`` and 9b's card session, up to its Phase 1, under
    ``videos/hour_session/``, each by its own name (phase 15 reads them;
    ``kept_session``)."""
    out, _ = writer.communicate(timeout=900)
    check(writer.returncode == 0, f"9: the video writer exited {writer.returncode}: {out[-2000:]}")
    probe = FlowProbe()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        day_counts = day_flow(ka, probe, smi, videos, tmp, H, zones)
        day = next(p for p in (tmp / "day").iterdir() if p.is_dir() and not p.is_symlink())
        shutil.copytree(day, videos / "day_session" / day.name)
        hour_counts, card, cfg = hour_flow(ka, probe, smi, videos, tmp)
        resumable_copy(card, videos / "hour_session" / card.name)
        resume_flow(ka, probe, card, cfg, tmp)
    return day_counts, hour_counts, probe


# ------------------------------------------------------------------ phase 10
# The training slice at full width: the JAX trainer's full-size defaults
# (tools/train_detr.py:245-246,471): DETR-R50, bf16 compute, 768x1344, batch
# 8, dropout 0.1, aux loss on; float32 master weights.
TRAIN_HW, TRAIN_BATCH, TRAIN_IMAGES = (768, 1344), 8, 16
# B.4 at the training shapes: DETR-R50 at 768x1344 (1008 tokens, 100
# queries) in bf16, and DETR-small at 224x384 in float32.
B4_CASES = [((8, 8, 1008, 1008, 32), "bfloat16", True, "R50 encoder, 768x1344"),
            ((8, 8, 100, 1008, 32), "bfloat16", True, "R50 cross, 768x1344"),
            ((8, 8, 100, 100, 32), "bfloat16", False, "R50 decoder self"),
            ((1, 8, 84, 84, 16), "float32", True, "DETR-small encoder")]
# DETR-small's card step against its CPU step (float32, TF32 off): each
# parameter's gradient within 1e-3 of that leaf's max |grad|. The card's
# forward is within 2.6e-6 of the CPU's in logits (K1 and cuDNN sum in
# another order); the backward carries that through 3+3 layers and the
# ResNet, and cuDNN's weight gradients sum over pixels in another order.
SMALL_GRAD_RTOL = 1e-3
# B.4's dq/dk/dv against float64 autograd of the plain version on the same
# values, and against the pair's plain version (relative_error: each element
# relative to max(1, |ref|) and each tensor relative to its max |ref|): bf16
# 2^-6 (P and dS are rounded to bf16 for the products, and so are the
# results); float32 1e-5 (summation order). The gate must reject the
# B4_FAULTS, planted in the pair's plain version, at every B4_CASES shape.
B4_BAR = {torch.bfloat16: 2.0**-6, torch.float32: 1e-5}
B4_FAULTS = ("D dropped", "zero scale in dQ/dK of the all-masked entry", "scale off by 2^-5")
# The forward's log-sum-exp against attention_lse, relative to max(1,
# |lse|): float32 summation order; bf16 scores are summed on the tensor cores
# from bf16 products, in another order than the plain version's.
LSE_TOL = {torch.bfloat16: 1e-4, torch.float32: 1e-5}


def exact_zero_gradient(key: str) -> bool:
    """Leaves whose gradient is zero in exact arithmetic, so that both sides
    hold only rounding noise (read against the largest gradient instead):
    every key-projection bias (it adds the same q.b to each score of a query,
    which the softmax cancels), and the first decoder layer's self-attention
    q and k projections and v weight (it reads tgt = 0, so every value is the
    v bias and the output does not depend on the probabilities)."""
    first = "decoder.layer_0.self_attn."
    return key.endswith("k_proj.bias") or key.startswith((first + "q_proj.", first + "k_proj.",
                                                          first + "v_proj.weight"))


def start_dataset_writer(out_dir: Path) -> subprocess.Popen:
    """Phase 10's data: 16 synthetic 720p COCO images (tools/gen_recipe_dataset.py)."""
    return subprocess.Popen([sys.executable, str(ROOT / "tools" / "gen_recipe_dataset.py"), "--out", str(out_dir),
                             "--train", str(TRAIN_IMAGES), "--val", "0"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def b4_bound(shape, dtype, mask, backward_only: bool = False) -> tuple[float, str]:
    """B.4's least time and what bounds it (attention_kernel_bench.b4_bound)."""
    from office_person_detection_vit_torch import attention_kernel_bench as abench

    return abench.b4_bound(shape, dtype, mask, backward_only)


def relative_error(got, want) -> float:
    """The larger of attention_kernel_bench.relative_errors' two readings:
    what B.4's gate holds to B4_BAR."""
    from office_person_detection_vit_torch.attention_kernel_bench import relative_errors

    return max(relative_errors(got, want))


def planted_fault_grads(q, k, v, mask, out, lse, g) -> dict:
    """(dq, dk, dv) of the pair's plain version with each B4_FAULTS fault
    planted: D = rowsum(g * out) left out of dS; dQ and dK of a batch entry
    with every key masked scaled by the zero score scale that P uses there
    (``mask``'s last entry must be all masked); dQ and dK scaled by
    (1 + 2^-5)/sqrt(D). A gate that passes any of them cannot tell a wrong
    backward from bf16 rounding."""
    from office_person_detection_vit_torch.ops.attention import _scores

    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = torch.exp(_scores(q, k, mask) - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dead = (~mask.any(-1)).view(-1, 1, 1, 1)

    def grads(ds, dq_dk_scale):
        dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * dq_dk_scale
        dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * dq_dk_scale
        return tuple(t.to(q.dtype) for t in (dq, dk, dv))

    ds = p * (dp - (gf * out.float()).sum(-1, keepdim=True))
    return dict(zip(B4_FAULTS, (grads(p * dp, scale), grads(ds, torch.where(dead, 0.0, scale)),
                                grads(ds, scale * (1 + 2.0**-5)))))


DETECT_LSE_CASES = [((8, 8, 920, 920, 32), "bfloat16", True, "R50 detect encoder"),
                    ((8, 8, 100, 920, 32), "bfloat16", True, "R50 detect cross"),
                    ((8, 8, 100, 100, 32), "bfloat16", False, "R50 detect decoder self")]


def lse_phase(ka, smi: str, cases=B4_CASES + DETECT_LSE_CASES, tag: str = "10a") -> None:
    """10a, first: the forward kernel that B.4 takes at each B4_CASES shape,
    and K2 at the detect path's three bf16 shapes (736x1280: 920 tokens),
    give the same bits with and without the log-sum-exp pointer, and the
    log-sum-exp matches attention_lse (LSE_TOL)."""
    from office_person_detection_vit_torch import attention_kernel_bench as abench
    from office_person_detection_vit_torch.ops.attention import attention_lse

    for seed, (shape, dt, masked, path) in enumerate(cases):
        dtype = abench.DTYPES[dt]
        q, k, v, mask = abench.make_inputs(shape, dtype, masked, 300 + seed)
        fn = ka.attention_flash if ka.use_flash(shape[3], shape[4], dtype) else ka.attention_whole_kv
        plain = fn(q, k, v, mask)
        out, lse = fn(q, k, v, mask, with_lse=True)
        want = attention_lse(q, k, mask)
        err = ((lse - want).abs() / want.abs().clamp(min=1.0)).max().item()
        check(torch.equal(plain, out), f"{tag} {shape} {dt}: {fn.__name__} with the lse pointer changed its output")
        check(err <= LSE_TOL[dtype], f"{tag} {shape} {dt}: lse off attention_lse by {err:.2e} (bar {LSE_TOL[dtype]:.0e})")
        log(f"[{tag}] {fn.__name__} {shape} {dt} ({path}): output bit-identical with and without lse; lse within "
            f"{err:.2e} of attention_lse relative to max(1,|lse|) (bar {LSE_TOL[dtype]:.0e})")


def b4_phase(ka, smi: str, cases=B4_CASES, lse_cases=B4_CASES + DETECT_LSE_CASES, tag: str = "10a") -> dict:
    """10a: B.4 (ops.attention.KernelAttention: K1/K2 forward with the
    log-sum-exp, the backward kernel pair) on the card at the training
    shapes: the forward at the kernels' bars; dq/dk/dv against float64
    autograd of the plain version (the gate, B4_BAR) and against the pair's
    plain version on the card (the same bar); two calls of the pair
    bit-identical; the plain autograd's own error against float64 printed
    beside them; the same values with the last batch entry all masked, where
    the pair passes the gate and each of B4_FAULTS fails it; and times."""
    from office_person_detection_vit_torch import attention_kernel_bench as abench
    from office_person_detection_vit_torch.ops import attention as oa
    from office_person_detection_vit_torch.ops.attention import (KernelAttention, attention_backward_reference,
                                                                 attention_reference)

    lse_phase(ka, smi, lse_cases, tag)
    rows = {}
    for seed, (shape, dt, masked, path) in enumerate(cases):
        dtype = abench.DTYPES[dt]
        q, k, v, mask = abench.make_inputs(shape, dtype, masked, 100 + seed)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(200 + seed)).to("cuda", dtype)
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        tol, bar = abench.TOLERANCE[dtype], B4_BAR[dtype]
        oa.reset_launch_counts()
        ka.reset_launch_counts()
        out = KernelAttention.apply(q, k, v, mask)
        grads = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
        torch.cuda.synchronize()
        check(oa.launch_counts["attention_diff"] == 1 and ka.launch_counts["attention_backward"] == 1,
              f"{tag} {shape}: B.4 launched {oa.launch_counts}, {ka.launch_counts}")
        x = [t.detach() for t in (q, k, v)]
        fn = ka.attention_flash if ka.use_flash(shape[3], shape[4], dtype) else ka.attention_whole_kv
        out2, lse = fn(*x, mask, with_lse=True)
        pair = [ka.attention_backward(*x, mask, out2, lse, g) for _ in range(2)]
        x64 = [t.double().requires_grad_(True) for t in x]
        exact = torch.autograd.grad(attention_reference(*x64, mask), x64, g.double())
        twin = attention_backward_reference(*x, mask, out2, lse, g)
        plain_grads = torch.autograd.grad(attention_reference(q, k, v, mask), (q, k, v), g)
        fwd_err = (out.float() - attention_reference(*(t.float() for t in x), mask)).abs().max().item()
        grad_err, twin_err = relative_error(grads, exact), relative_error(grads, twin)
        plain_err = relative_error(plain_grads, exact)
        grad_abs = max((a.double() - b).abs().max().item() for a, b in zip(grads, exact))
        check(all(bool(torch.isfinite(t).all()) for t in (out, *grads)), f"{tag} {shape}: non-finite B.4 output")
        check(torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(pair[0], pair[1]))
              and all(torch.equal(a, b) for a, b in zip(pair[0], grads)),
              f"{tag} {shape} {dt}: the forward or the backward pair is not the same bits from call to call")
        check(fwd_err <= tol and grad_err <= bar and twin_err <= bar,
              f"{tag} {shape} {dt}: forward err {fwd_err:.2e} (bar {tol:.0e}); dq/dk/dv against float64 autograd "
              f"{grad_err:.2e}, against attention_backward_reference {twin_err:.2e} (bar {bar:.2e})")
        # the same values with the last batch entry's keys all masked: the pair, and the planted faults
        dead = (torch.ones(shape[0], shape[3], dtype=torch.bool, device="cuda") if mask is None else mask).clone()
        dead[-1] = False
        xd = [t.clone().requires_grad_(True) for t in x]
        dead_grads = torch.autograd.grad(KernelAttention.apply(*xd, dead), xd, g)
        x64 = [t.double().requires_grad_(True) for t in x]
        exact_dead = torch.autograd.grad(attention_reference(*x64, dead), x64, g.double())
        dead_err = relative_error(dead_grads, exact_dead)
        planted = planted_fault_grads(*x, dead, *fn(*x, dead, with_lse=True), g)
        faults = {name: abench.relative_errors(f, exact_dead) for name, f in planted.items()}
        fault_text = "; ".join(f"{name} {e:.2e} / {m:.2e}" for name, (e, m) in faults.items())
        check(dead_err <= bar and all(max(r) > bar for r in faults.values()),
              f"{tag} {shape} {dt}, last entry all masked: the pair {dead_err:.2e} (bar {bar:.2e}); the planted "
              f"faults must read over the bar (per element / per tensor): {fault_text}")
        log(f"[{tag}] B.4 {shape} {dt}, last entry all masked: the pair against float64 autograd {dead_err:.2e} "
            f"(bar {bar:.2e}); planted faults in the pair's plain version, rejected (per element / per tensor): "
            f"{fault_text}")
        del xd, dead_grads, exact_dead, planted

        def fwd_bwd(fn):
            def run():
                o = fn(q, k, v, mask)
                torch.autograd.grad(o, (q, k, v), g)
            return run

        sdpa_mask = None if mask is None else mask[:, None, None, :]

        def sdpa(q, k, v, mask):
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)

        sdpa_out = sdpa(q, k, v, mask)
        b_ms, b_by = b4_bound(shape, dtype, mask)
        bb_ms, bb_by = b4_bound(shape, dtype, mask, backward_only=True)
        row = {
            "shape": list(shape), "dtype": dt, "path": path, "max_abs_err": max(fwd_err, grad_abs),
            "forward_err": fwd_err, "grad_err_vs_float64_rel": grad_err, "grad_err_vs_twin_rel": twin_err,
            "plain_autograd_err_vs_float64_rel": plain_err, "grad_bar": bar, "all_masked_entry_err": dead_err,
            "planted_faults_rel": {name: max(r) for name, r in faults.items()},
            "ms": abench.cuda_ms(fwd_bwd(KernelAttention.apply), 10),
            "forward_ms": abench.cuda_ms(lambda: KernelAttention.apply(*x, mask), 10),
            "backward_ms": abench.cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True), 10),
            "pair_ms": abench.cuda_ms(lambda: ka.attention_backward(*x, mask, out2, lse, g), 10),
            "plain_ms": abench.cuda_ms(fwd_bwd(attention_reference), 5),
            "plain_backward_ms": abench.cuda_ms(lambda: attention_backward_reference(*x, mask, out2, lse, g), 5),
            "library_ms": abench.cuda_ms(fwd_bwd(sdpa), 10),
            "library_backward_ms": abench.cuda_ms(
                lambda: torch.autograd.grad(sdpa_out, (q, k, v), g, retain_graph=True), 10),
            "bound_ms": b_ms, "bound_by": b_by, "backward_bound_ms": bb_ms, "backward_bound_by": bb_by,
        }
        rows[shape] = row
        log(f"[{tag}] B.4 {shape} {dt} ({path}): forward err {fwd_err:.2e} (bar {tol:.0e}); dq/dk/dv of the "
            f"backward pair against float64 autograd {grad_err:.2e}, against attention_backward_reference "
            f"{twin_err:.2e} (bar {bar:.2e}, relative_error); plain autograd in {dt} against float64 "
            f"{plain_err:.2e} (diagnostic); two calls of the pair bit-identical")
        log(f"[{tag}] B.4 {shape} {dt}: forward+backward {row['ms']:.4f} ms (forward {row['forward_ms']:.4f}, "
            f"backward {row['backward_ms']:.4f}, the pair alone {row['pair_ms']:.4f}), plain autograd "
            f"{row['plain_ms']:.4f}, the pair's plain version {row['plain_backward_ms']:.4f}, SDPA "
            f"{row['library_ms']:.4f} (backward alone {row['library_backward_ms']:.4f}); bound {b_ms:.4f} ({b_by}), "
            f"the backward's {bb_ms:.4f} ({bb_by}, {100 * bb_ms / row['pair_ms']:.1f}% of it) on {smi}")
        del q, k, v, g, out, grads, x, x64, exact, twin, plain_grads, pair, out2, lse, sdpa_out
    torch.cuda.empty_cache()
    return rows


def wait_dataset(writer: subprocess.Popen, data: Path) -> list:
    from office_person_detection_vit_torch.train_detr import load_coco_dataset

    out, _ = writer.communicate(timeout=300)
    check(writer.returncode == 0, f"10: gen_recipe_dataset exited {writer.returncode}: {out[-2000:]}")
    samples = load_coco_dataset(data / "train" / "images", data / "train" / "coco.json")
    check(len(samples) == TRAIN_IMAGES, f"10: {len(samples)} samples, expected {TRAIN_IMAGES}")
    return samples


def to_device(host_batch: dict, hw, dtype) -> dict:
    from office_person_detection_vit_torch.ops.preprocessing import preprocess_frames

    pixels, mask = preprocess_frames(torch.from_numpy(host_batch["frames_u8"]).cuda(), target_hw=hw, out_dtype=dtype)
    return {"pixels": pixels, "pixel_mask": mask,
            **{k: torch.from_numpy(host_batch[k]).cuda() for k in ("labels", "boxes", "valid")}}


def moved_check(where: str, keys, before, params) -> int:
    """Every leaf with a nonzero gradient moved. The first decoder layer's
    self-attention reads tgt = 0, so its q, k and v projections get none;
    their weight decay alone (lr x 1e-4 of the value) is under float32's
    resolution and leaves them as they were, as it does in JAX."""
    for k, a, p in zip(keys, before, params):
        if torch.equal(a, p.detach()):
            check(p.grad is None or not p.grad.any(), f"{where}: {k} has a gradient and did not move")
    return sum(not torch.equal(a, p.detach()) for a, p in zip(before, params))


def train_full_width(ka, smi: str, samples: list, cfg=None, tag: str = "10b", calls: int = 18,
                     leaves: int = 424, name: str = "DETR-R50") -> dict:
    """10b: DETR-R50 bf16 training steps at 768x1344, batch 8, through the
    port's loader, augmentation and train step (another model with ``cfg``:
    ``calls`` attention calls a step, ``leaves`` Flax leaves)."""
    from office_person_detection_vit_torch.models.detr import DETR, DETRConfig
    from office_person_detection_vit_torch.ops import attention as oa
    from office_person_detection_vit_torch.training import (AugmentConfig, COCOBatchLoader, TrainState,
                                                            content_width, make_optimizer, make_train_step)

    cfg = cfg or DETRConfig(dtype="bfloat16", dropout=0.1)
    model = DETR(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model.cuda()
    check(all(p.dtype == torch.float32 for p in model.parameters()), f"{tag}: master weights are not float32")
    tx = make_optimizer(learning_rate=1e-4, backbone_lr=1e-5)
    state = TrainState.create(model, tx)
    check(len(state.params) == leaves,
          f"{tag}: {len(state.params)} trainable tensors, expected the {leaves} Flax leaves")
    step = make_train_step(model, tx, augment=AugmentConfig(content_w=content_width(TRAIN_HW)))
    loader = COCOBatchLoader(samples, TRAIN_BATCH, capacity=32, seed=0)
    generator = torch.Generator().manual_seed(1)
    before = [p.detach().clone() for p in state.params]

    def batches():
        for epoch in range(4):
            yield from loader.epoch(epoch)

    names = ["forward", "matcher", "loss", "backward", "optimizer"]
    split = {n: [] for n in names}
    host, dev, k2, b4, losses = [], [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i, host_batch in enumerate(batches()):
        torch.cuda.synchronize()
        ka.reset_launch_counts()
        oa.reset_launch_counts()
        events = {n: torch.cuda.Event(enable_timing=True) for n in ["start", *names]}
        t = time.perf_counter()
        events["start"].record()
        state, metrics = step(state, to_device(host_batch, TRAIN_HW, cfg.torch_dtype), generator,
                              mark=lambda n: events[n].record())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        k2.append(dict(ka.launch_counts))
        b4.append(oa.launch_counts["attention_diff"])
        losses.append({k: v.item() for k, v in metrics.items()})
        if i >= 2:  # 2 warm-up steps
            host.append(secs * 1e3)
            dev.append(events["start"].elapsed_time(events["optimizer"]))
            prev = "start"
            for n in names:
                split[n].append(events[prev].elapsed_time(events[n]))
                prev = n
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(len(host) == 6, f"{tag}: {len(host)} timed steps")
    check(all(c == launches(flash=calls, backward=calls) for c in k2) and all(n == calls for n in b4),
          f"{tag}: launches a step {k2}, B.4 {b4} (expected {calls} K2 through B.4 and {calls} backward pairs, no K1)")
    check(all(math.isfinite(v) for row in losses for v in row.values()), f"{tag}: non-finite losses {losses}")
    moved = moved_check(tag, state.keys, before, state.params)
    mean = {n: sum(v) / len(v) for n, v in split.items()}
    dev_ms, host_ms = sum(dev) / len(dev), sum(host) / len(host)
    log(f"[{tag}] {name} bf16 (float32 master weights) 768x1344 batch {TRAIN_BATCH}, dropout 0.1, aux loss, "
        f"augment; {TRAIN_IMAGES} synthetic 720p images through COCOBatchLoader; 2 warm-up + 6 timed steps: "
        f"{dev_ms:.3f} ms a step (CUDA events; steps {', '.join(f'{x:.3f}' for x in dev)}), host "
        f"{host_ms:.3f} ms a step with the upload and preprocessing ({', '.join(f'{x:.3f}' for x in host)}), "
        f"{TRAIN_BATCH * 1e3 / host_ms:.2f} images/s, peak memory {peak:.2f} GiB on {smi}")
    log(f"[{tag}] split of a step (mean ms, CUDA events): "
        + ", ".join(f"{n} {mean[n]:.3f} ({100 * mean[n] / dev_ms:.1f}%)" for n in names))
    log(f"[{tag}] launches a step: {k2[-1]} through B.4 ({b4[-1]} forwards, one backward pair each); {moved} of {len(state.keys)} "
        f"parameters moved (every one with a gradient); losses first {losses[0]}, last {losses[-1]}")
    counts = {"attention_diff": sum(b4[2:]), **{name: sum(c[name] for c in k2[2:]) for name in launches()}}
    del state, model, step
    torch.cuda.empty_cache()
    return {"counts": counts, "step_ms": dev_ms, "host_ms": host_ms, "split": mean, "peak_gib": peak}


def train_small_card_vs_cpu(ka, smi: str, samples: list) -> dict:
    """10c: one step of the committed DETR-small checkpoint (float32) on the
    card (K1 forward through B.4, TF32 off) and on the CPU, from the same
    weights and batch: the same matches, the losses within 1e-4 relative,
    every gradient within SMALL_GRAD_RTOL of its leaf's max |grad|."""
    from office_person_detection_vit_torch.device import full_float32
    from office_person_detection_vit_torch.models.detr import DETR, DETRConfig
    from office_person_detection_vit_torch.models.weights import load_checkpoint
    from office_person_detection_vit_torch.ops import attention as oa
    from office_person_detection_vit_torch.ops.preprocessing import preprocess_frames
    from office_person_detection_vit_torch.training import COCOBatchLoader, CriterionConfig
    from office_person_detection_vit_torch.training.criterion import match
    from office_person_detection_vit_torch.training.train_step import gradients, loss_fn, ordered_parameters

    cfg = DETRConfig.small()
    sd = load_checkpoint(ROOT / "docs" / "artifacts" / "detr_small_weights.npz", cfg)
    host_batch = next(iter(COCOBatchLoader(samples[:2], 2, capacity=cfg.num_queries, seed=0).epoch(0)))
    pixels, mask = preprocess_frames(torch.from_numpy(host_batch["frames_u8"]), target_hw=(224, 384))
    batch = {"pixels": pixels, "pixel_mask": mask, **{k: torch.from_numpy(host_batch[k])
                                                    for k in ("labels", "boxes", "valid")}}
    crit = CriterionConfig(num_classes=cfg.num_classes)
    runs = {}
    for where in ("cuda", "cpu"):
        model = DETR(cfg)
        model.load_state_dict(sd)
        model.to(where).train()
        b = {k: v.to(where) for k, v in batch.items()}
        ka.reset_launch_counts()
        oa.reset_launch_counts()
        with full_float32():
            out = model(b["pixels"], b["pixel_mask"], return_aux=True)
            logits = torch.cat([out["aux_logits"], out["logits"][None]])
            boxes = torch.cat([out["aux_boxes"], out["boxes"][None]])
            L = logits.shape[0]
            idx = match(logits, boxes, b["labels"].expand(L, *b["labels"].shape),
                        b["boxes"].expand(L, *b["boxes"].shape), b["valid"].expand(L, *b["valid"].shape), crit)
            model.zero_grad(set_to_none=True)
            total, metrics = loss_fn(model, crit, b, None, True)
            total.backward()
            if where == "cuda":
                torch.cuda.synchronize()
        keys, params = ordered_parameters(model)
        runs[where] = {"idx": idx.cpu(), "metrics": {k: v.item() for k, v in metrics.items()},
                       "grads": [g.detach().cpu() for g in gradients(params)], "keys": keys,
                       "counts": dict(ka.launch_counts), "b4": oa.launch_counts["attention_diff"]}
    card, cpu = runs["cuda"], runs["cpu"]
    check(torch.equal(card["idx"], cpu["idx"]), f"10c: matches differ, card {card['idx'].tolist()} cpu {cpu['idx'].tolist()}")
    check(card["counts"] == launches(whole_kv=18, backward=9) and card["b4"] == 18,
          f"10c: card launches {card['counts']}, B.4 {card['b4']} (expected 18 K1: two forwards of 9 calls, the "
          "matcher's and the loss's, and 9 backward pairs: the loss's graph)")
    loss_err = max(abs(card["metrics"][k] - v) / max(abs(v), 1e-12) for k, v in cpu["metrics"].items())
    check(loss_err <= 1e-4, f"10c: losses card {card['metrics']} cpu {cpu['metrics']}")
    worst, worst_key = 0.0, ""
    top = max(g.abs().max().item() for g in cpu["grads"])
    for key, a, b in zip(card["keys"], card["grads"], cpu["grads"]):
        scale = top if exact_zero_gradient(key) else max(b.abs().max().item(), 1e-30)
        r = (a - b).abs().max().item() / scale
        if r > worst:
            worst, worst_key = r, key
    check(worst <= SMALL_GRAD_RTOL, f"10c: gradient {worst_key} off by {worst:.2e} of its leaf's max |grad|")
    log(f"[10c] DETR-small checkpoint, one float32 step (batch 2, 224x384, aux loss) on the card (K1 through "
        f"B.4: {card['counts']}) and on the CPU: matches equal ({card['idx'].shape[0]} layers x 2 images), "
        f"losses within {loss_err:.2e} relative (bar 1e-4), worst gradient {worst:.2e} of its leaf's max |grad| "
        f"({worst_key}; bar {SMALL_GRAD_RTOL:.0e}) on {smi}")
    return {"attention_whole_kv": card["counts"]["attention_whole_kv"],
            "attention_backward": card["counts"]["attention_backward"]}


def fine_tune_handoff(ka, smi: str, data: Path, tmp: Path, frame: np.ndarray) -> dict:
    """10d: ``main --fine-tune`` with the training.* keys on 10b's data at
    full size for one epoch, then its weights.npz in DETRDetector on the card."""
    import logging

    import yaml

    from office_person_detection_vit_torch.detection.detector import DETRDetector
    from office_person_detection_vit_torch.main import main as port_main
    from office_person_detection_vit_torch.ops import attention as oa

    out = tmp / "fine_tune"
    cfg = {"detection": {"device": "cuda"}, "output": {"directory": str(tmp / "logs")},
           "training": {"images_dir": str(data / "train" / "images"), "annotations": str(data / "train" / "coco.json"),
                        "epochs": 1, "batch_size": TRAIN_BATCH, "output_dir": str(out),
                        "input_height": TRAIN_HW[0], "input_width": TRAIN_HW[1], "learning_rate": 1e-4,
                        "augment": True}}
    path = tmp / "fine_tune.yaml"
    path.write_text(yaml.safe_dump(cfg))
    ka.reset_launch_counts()
    oa.reset_launch_counts()
    t = time.perf_counter()
    with path.with_suffix(".log").open("w") as console, contextlib.redirect_stdout(console):
        rc = port_main(["--config", str(path), "--fine-tune"])
        root = logging.getLogger()
        for handler in list(root.handlers):
            root.removeHandler(handler)
            handler.close()
    secs = time.perf_counter() - t
    counts = {**ka.launch_counts, "attention_diff": oa.launch_counts["attention_diff"]}
    if rc != 0:
        log("\n".join(path.with_suffix(".log").read_text().splitlines()[-60:]))
    check(rc == 0, f"10d: main --fine-tune exited {rc}")
    history = json.loads((out / "history.json").read_text())
    steps = TRAIN_IMAGES // TRAIN_BATCH
    check(len(history["step_losses"]) == steps and all(math.isfinite(x) for x in history["step_losses"]),
          f"10d: history {history['step_losses']}")
    check(counts == {**launches(flash=18 * steps, backward=18 * steps), "attention_diff": 18 * steps},
          f"10d: launches {counts}, expected 18 K2 through B.4 and 18 backward pairs a step x {steps}")
    det = DETRDetector({"detection.model_size": "full", "detection.dtype": "bfloat16", "detection.device": "cuda",
                        "detection.checkpoint_path": str(out / "weights.npz"), "detection.batch_size": 1,
                        "detection.input_height": 736, "detection.input_width": 1280,
                        "detection.confidence_threshold": 0.0})
    det.load_model()
    batch = det.detect_batch(frame[None])
    check(det.last_failed_chunks == 0 and np.isfinite(batch.boxes_xywh).all() and np.isfinite(batch.scores).all(),
          "10d: the trained weights do not detect")
    log(f"[10d] main --fine-tune (training.* keys, full size, 1 epoch, {steps} steps): exit 0 in {secs:.3f} s, "
        f"launches {counts}; history.json losses {[round(x, 4) for x in history['step_losses']]}; weights.npz "
        f"({(out / 'weights.npz').stat().st_size} bytes) loaded into DETRDetector on the card, one frame detected "
        f"({int(batch.valid.sum())} boxes at confidence 0) on {smi}")
    det.cleanup()
    return counts


def training_phase(ka, smi: str, dataset_writer: subprocess.Popen, data: Path, frame: np.ndarray) -> dict:
    """Phase 10: the training slice on the card."""
    t = time.perf_counter()
    b4_rows = b4_phase(ka, smi)
    samples = wait_dataset(dataset_writer, data)
    full = train_full_width(ka, smi, samples)
    small = train_small_card_vs_cpu(ka, smi, samples)
    with tempfile.TemporaryDirectory() as tmp:
        handoff = fine_tune_handoff(ka, smi, data, Path(tmp), frame)
    log(f"[10] training phase {time.perf_counter() - t:.1f} s")
    return {"b4": b4_rows, "full": full, "small": small, "handoff": handoff}


# ------------------------------------------------------------------ phase 11
# [11a]'s load: a workday of dense tracking, 8 hours on the default 10 s grid
# of video.dense_tracking (2,880 frames), 30 people on seeded random walks in
# a 1280x720 frame, as Phase 2 would hand them to the tracker: box noise, 5%
# of detections dropped, 2 false positives a frame, and a 256-d feature a
# detection (DETR's d_model: the person's mean plus noise, L2-normalised);
# 64 track slots.
WORKDAY_FRAMES, WORKDAY_STEP_S, WORKDAY_PEOPLE, WORKDAY_FP, WORKDAY_DROP = 8 * 3600 // 10, 10, 30, 2, 0.05
WORKDAY_CAPACITY, FEATURE_DIM = 64, 256
#: Frames of the profiled window that counts the scan's kernel launches.
LAUNCH_WINDOW = 50
# [11b]: the committed showcase (tools/e2e_showcase.py): 600 video frames on
# a 60 s dense grid (104 frames), the DETR-small checkpoint at conf 0.2, NMS
# 0.3, sigmoid scores. The card's MOTA and IDF1 must be within this of the
# CPU's on the same extracted frames.
SHOWCASE_FRAMES, SHOWCASE_SCORE_TOL = 600, 0.01
# [11c]: random weights find nobody at the usual threshold, so the threshold
# is set from the scores of a run at 0.0 to give each frame 20-60
# detections, a load on the ROI-pooled features and the association (not a
# test of quality). A random class head makes person the top class of about
# one query in 91, and postprocess keeps only those, so every other class's
# row of the head is set to -20 (person_head); and the scores are sigmoids,
# since a softmax over 92 classes puts a random model's person score near
# 1/92, under the trackers' floor (0.1) and their threshold to start a track
# (0.3).
LOAD_DETECTIONS = (20, 60)


def workday_load(frames: int = WORKDAY_FRAMES, people: int = WORKDAY_PEOPLE, seed: int = 11,
                 who: list | None = None) -> tuple[dict, list]:
    """[11a]'s ground truth {MOT frame: [(person id, xywh)]} and its
    FrameResults (timestamps every WORKDAY_STEP_S seconds, the detections
    in a seeded order, features on every detection). ``who``, when given,
    gets each frame's detections' person indices (-1: a false positive) in
    that order."""
    from office_person_detection_vit_torch.core.dto import Detection, FrameResult

    rng = np.random.default_rng(seed)
    wh = rng.uniform([45, 120], [80, 200], (people, 2))
    pos = rng.uniform([0, 0], [1280 - 80, 720 - 200], (people, 2))
    vel = np.zeros((people, 2))
    looks = rng.normal(size=(people, FEATURE_DIM))
    looks /= np.linalg.norm(looks, axis=1, keepdims=True)
    gt, results = {}, []
    for f in range(frames):
        vel = 0.7 * vel + rng.normal(0, 12, (people, 2))
        pos += vel
        lo, hi = np.zeros(2), np.array([1280.0, 720.0]) - wh
        over, under = pos > hi, pos < lo  # reflect at the frame's edges
        pos = np.where(over, 2 * hi - pos, np.where(under, 2 * lo - pos, pos))
        vel = np.where(over | under, -vel, vel)
        gt[f + 1] = [(p + 1, (float(pos[p, 0]), float(pos[p, 1]), float(wh[p, 0]), float(wh[p, 1])))
                     for p in range(people)]
        dets, pids = [], []
        for p in range(people):
            if rng.random() < WORKDAY_DROP:
                continue
            pids.append(p)
            box = (*(pos[p] + rng.normal(0, 3, 2)), *(wh[p] + rng.normal(0, 2, 2)))
            feat = looks[p] + rng.normal(0, 0.4 / np.sqrt(FEATURE_DIM), FEATURE_DIM)
            dets.append(Detection(bbox=tuple(float(v) for v in box), confidence=float(rng.uniform(0.5, 0.99)),
                                  feature=(feat / np.linalg.norm(feat)).astype(np.float32)))
        for _ in range(WORKDAY_FP):
            xy = rng.uniform([0, 0], [1200, 560])
            feat = rng.normal(size=FEATURE_DIM)
            dets.append(Detection(bbox=(float(xy[0]), float(xy[1]), 60.0, 150.0),
                                  confidence=float(rng.uniform(0.3, 0.6)),
                                  feature=(feat / np.linalg.norm(feat)).astype(np.float32)))
            pids.append(-1)
        order = rng.permutation(len(dets))
        results.append(FrameResult(f, HOUR_START + timedelta(seconds=WORKDAY_STEP_S * f), [dets[i] for i in order]))
        if who is not None:
            who.append(np.asarray(pids)[order])
    return gt, results


def hypothesis(results: list, ids: np.ndarray | None = None) -> dict:
    """{MOT frame: [(track id, xywh)]} of the tracked detections: the ids of
    the (F, D) matrix when given, else each detection's track_id."""
    hyp = {}
    for f, fr in enumerate(results):
        tids = [d.track_id for d in fr.detections] if ids is None else [int(i) for i in ids[f, :len(fr.detections)]]
        hyp[f + 1] = [(t, tuple(d.bbox)) for t, d in zip(tids, fr.detections) if t is not None and t >= 0]
    return hyp


def score_part(job: tuple) -> dict:
    """One of scores' two evaluations: ("mot" or "hota", gt, hyp)."""
    from office_person_detection_vit_torch.benchmark.mot_metrics import evaluate_hota, evaluate_mot

    what, gt, hyp = job
    if what == "hota":
        return {"hota": evaluate_hota(gt, hyp).hota}
    mot = evaluate_mot(gt, hyp).to_dict()
    return {"mota": mot["mota"], "idf1": mot["idf1"], "idsw": mot["id_switches"]}


def scores(gt: dict, hyp: dict) -> dict:
    """MOTA, IDF1 and HOTA of the port's mot_metrics."""
    return score_part(("mot", gt, hyp)) | score_part(("hota", gt, hyp))


def scores_apart(gt: dict, hyps: dict) -> dict:
    """scores of each named hypothesis, every evaluation in a process of its
    own (forked: they run numpy and scipy on the host and touch no CUDA)."""
    import multiprocessing

    jobs = [(name, what) for name in hyps for what in ("mot", "hota")]
    with multiprocessing.get_context("fork").Pool(len(jobs)) as pool:
        parts = pool.map_async(score_part, [(what, gt, hyps[name]) for name, what in jobs]).get(timeout=600)
    got = {name: {} for name in hyps}
    for (name, _), part in zip(jobs, parts):
        got[name].update(part)
    return got


def scan_launches(arrays: list, kw: dict) -> float | None:
    """Device operations (kernels, copies, fills) a frame of the scan on the
    card, counted by torch.profiler over LAUNCH_WINDOW frames; None when the
    profiler sees no device activity."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from office_person_detection_vit_torch.tracking.scan_tracker import init_state, scan_track

    window = [a[:LAUNCH_WINDOW] for a in arrays]
    state = init_state(WORKDAY_CAPACITY, arrays[3].shape[-1], "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        scan_track(state, *window, **kw)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return n / LAUNCH_WINDOW if n else None


def workday_phase(smi: str) -> dict:
    """[11a]: the workday through the scan on the card (inside
    set_sync_debug_mode("error")), the port's scan on the CPU and the
    cascade on the host; the card's ids equal to the CPU scan's; each
    engine's scores against the generator's ground truth, its seconds a
    1,000 frames, and the scan's device operations a frame."""
    import copy

    from office_person_detection_vit_torch.tracking.scan_tracker import init_state, pack_frame_results, scan_track
    from office_person_detection_vit_torch.tracking.tracker import Tracker

    t = time.perf_counter()
    gt, results = workday_load()
    arrays = [torch.from_numpy(a) for a in pack_frame_results(results)]
    F, D = arrays[1].shape
    log(f"[11a] workday load: {F} frames ({F * WORKDAY_STEP_S / 3600:.0f} h at {WORKDAY_STEP_S} s), {WORKDAY_PEOPLE} "
        f"people, {sum(len(r.detections) for r in results)} detections (at most {D} a frame), features "
        f"{arrays[3].shape[-1]}-d, capacity {WORKDAY_CAPACITY}; made in {time.perf_counter() - t:.1f} s")
    kw = {"max_age": 100, "min_hits": 1, "appearance_weight": 0.9, "motion_weight": 0.1,
          "max_position_distance": 10000.0}  # Tracker.from_config's defaults, as the phase passes them
    card_in = [a.cuda() for a in arrays]
    scan_track(init_state(WORKDAY_CAPACITY, FEATURE_DIM, "cuda"), *(a[:20] for a in card_in), **kw)  # warm-up
    state = init_state(WORKDAY_CAPACITY, FEATURE_DIM, "cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")  # a host sync inside the loop raises
    try:
        state, card_ids = scan_track(state, *card_in, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    secs = {"scan (card)": time.perf_counter() - t}
    check(card_ids.is_cuda and state.kf_x.is_cuda, "11a: the scan's state left the card")
    t = time.perf_counter()
    _, cpu_ids = scan_track(init_state(WORKDAY_CAPACITY, FEATURE_DIM), *arrays, **kw)
    secs["scan (CPU)"] = time.perf_counter() - t
    card_ids = card_ids.cpu().numpy()
    differ = int((card_ids != cpu_ids.numpy()).sum())
    check(differ == 0, f"11a: the card's scan ids differ from the CPU's at {differ} of {card_ids.size} places")
    cascade = copy.deepcopy(results)
    tracker = Tracker(max_age=kw["max_age"], min_hits=kw["min_hits"])
    t = time.perf_counter()
    for fr in cascade:
        tracker.update(fr.detections, fr.timestamp.timestamp())
    secs["cascade (host)"] = time.perf_counter() - t
    per_frame = scan_launches(card_in, kw)
    t = time.perf_counter()
    got = scores_apart(gt, {"scan": hypothesis(results, card_ids), "cascade": hypothesis(cascade)})
    scored = time.perf_counter() - t
    for name, s in got.items():
        check(all(math.isfinite(v) for v in s.values()) and s["mota"] > 0.5,
              f"11a: {name} scores {s} (MOTA must be above 0.5 on this load)")
    log(f"[11a] card scan ids == CPU scan ids at all {card_ids.size} (frame, detection) places, "
        f"{len(np.unique(card_ids[card_ids > 0]))} track ids; the loop ran under set_sync_debug_mode('error')")
    for name, s in got.items():
        log(f"[11a] {name}: MOTA {s['mota']:.4f}, IDF1 {s['idf1']:.4f}, HOTA {s['hota']:.4f}, ID switches {s['idsw']} "
            f"(port mot_metrics against the generator's ground truth; the card's and the CPU's scan ids are equal)")
    log(f"[11a] seconds a 1,000 frames: " + ", ".join(f"{k} {1000 * v / F:.3f}" for k, v in secs.items())
        + f" (host clock, the card synchronised; {F} frames); the scan's device operations a frame: "
        + (f"{per_frame:.1f} (torch.profiler over {LAUNCH_WINDOW} frames)" if per_frame else "not measured (the "
           "profiler saw no device activity)") + f"; scoring {scored:.1f} s (four processes); on {smi}")
    return {"secs": secs, "scores": got, "launches_per_frame": per_frame}


def showcase_tool(*args: str) -> None:
    """``tools/e2e_showcase.py`` in a child process (gen-video, gen-config
    and gold-gt import nothing of the JAX package)."""
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "e2e_showcase.py"), *args], capture_output=True,
                         text=True, timeout=600)
    check(out.returncode == 0, f"11b: e2e_showcase {args[0]} exited {out.returncode}: {out.stderr[-2000:]}")


def mot_rows(session: Path) -> dict:
    """tracks_mot.csv as {MOT frame: [(id, x, y, w, h, conf)]}."""
    rows = {}
    for r in csv.reader((session / "03_tracking" / "tracks_mot.csv").open()):
        rows.setdefault(int(r[0]), []).append((int(r[1]), *(float(v) for v in r[2:7])))
    return rows


def check_showcase_sessions(card: Path, cpu: Path, frames: int) -> tuple[int, int, list]:
    """[11b]'s gates on the two sessions' files: tracks_mot.csv row for row
    where the runs' detections pair one to one, and zone_counts.csv with the
    dense-tracking dedup. Returns the rows with the same id, the rows in one
    run only and zone_counts.csv's rows."""
    # tracks_mot.csv row for row where the two runs' detections pair one to
    # one (the [9b] pairing): one consistent id map, the identity unless a
    # detection within 1e-3 of the threshold is in one run only.
    card_rows, cpu_rows = mot_rows(card), mot_rows(cpu)
    id_map, rows_equal, left = {}, 0, 0
    as_dict = lambda r: {"bbox": dict(zip(("x", "y", "width", "height"), r[1:5])), "id": r[0], "conf": r[5]}
    for f in sorted(set(card_rows) | set(cpu_rows)):
        pairs, rest = matched([as_dict(r) for r in card_rows.get(f, [])], [as_dict(r) for r in cpu_rows.get(f, [])])
        left += len(rest)
        for d in rest:
            check(abs(d["conf"] - 0.2) <= 1.5e-3 or abs(d["conf"] - 0.3) <= 1.5e-3,
                  f"11b: MOT frame {f}: a track row in one run only, away from the thresholds: {d}")
        for a, b in pairs:
            check(id_map.setdefault(a["id"], b["id"]) == b["id"],
                  f"11b: MOT frame {f}: card id {a['id']} is CPU id {b['id']} here, {id_map[a['id']]} before")
            check(max(abs(a["bbox"][k] - b["bbox"][k]) for k in a["bbox"]) <= 1.3 + 0.01
                  and abs(a["conf"] - b["conf"]) <= 2e-3, f"11b: MOT frame {f}: {a} against {b}")
            rows_equal += a["id"] == b["id"]
    check(len(set(id_map.values())) == len(id_map), f"11b: card ids map onto CPU ids {id_map} not one to one")
    check(left > 0 or all(k == v for k, v in id_map.items()), f"11b: card and CPU ids differ: {id_map}")

    # zone_counts.csv has the dense-tracking dedup: one row an output window,
    # and each row counts the track ids seen in its window once.
    window_s = 60 * 5
    index = list(csv.DictReader((card / "03_tracking" / "frames_index.csv").open()))
    windows = {}
    for r in index:
        windows.setdefault(int(datetime.fromisoformat(r["timestamp"]).timestamp() // window_s), set())
    for r in csv.DictReader((card / "03_tracking" / "tracks.csv").open()):
        windows[int(datetime.fromisoformat(r["timestamp"]).timestamp() // window_s)].add(int(r["track_id"]))
    zone_rows = list(csv.DictReader((card / "05_aggregation" / "zone_counts.csv").open()))
    check(len(zone_rows) == len(windows) < frames,
          f"11b: zone_counts.csv has {len(zone_rows)} rows for {len(windows)} windows of {frames} frames")
    totals = [int(r["total"]) for r in zone_rows]
    check(totals == [len(windows[w]) for w in sorted(windows)],
          f"11b: zone_counts.csv totals {totals}, distinct track ids a window {[len(windows[w]) for w in sorted(windows)]}")
    return rows_equal, left, zone_rows


def resumable_copy(src: Path, dst: Path) -> Path:
    """A session for ``main --resume`` at ``dst`` holding only ``src``'s Phase
    1: its frames and extraction_results.csv (frame paths moved to the
    copy), metadata and config, and a checkpoint of 01_extraction alone."""
    shutil.copytree(src / "01_extraction", dst / "01_extraction")
    for name in ("metadata.json", "config.yaml"):
        shutil.copy(src / name, dst / name)
    state = json.loads((src / "pipeline_checkpoint.json").read_text())
    state["phases"] = {"01_extraction": state["phases"]["01_extraction"]}
    (dst / "pipeline_checkpoint.json").write_text(json.dumps(state))
    csv_path = dst / "01_extraction" / "extraction_results.csv"
    rows = list(csv.reader(csv_path.open()))
    for r in rows[1:]:
        r[-1] = str(dst / "01_extraction" / "frames" / Path(r[-1]).name)
    with csv_path.open("w", newline="") as f:
        csv.writer(f).writerows(rows)
    return dst


def showcase_phase(ka, probe, smi: str, tmp: Path, given: Path | None = None) -> dict:
    """[11b]: the committed showcase through main on the card, then Phases
    2-5 of the same session on the CPU (a copy resumed after 01_extraction,
    so the OCR runs once); both tracks_mot.csv scored against the gold GT.

    The video is gen-video's, made here. With ``given``, a directory holding
    ``session/`` (a showcase session made on another machine) and its
    ``scenario.json``, the card resumes that session after its Phase 1
    instead: OpenCV builds draw the burned-in timestamp differently, the
    DETR-small checkpoint sees that band, and the OCR's templates are drawn
    by the local build, so scores compare across machines only on the same
    extracted frames."""
    import yaml

    from office_person_detection_vit_torch.benchmark.mot_metrics import (
        evaluate_hota, evaluate_mot, load_gold_gt, load_mot_csv)

    video = tmp / "showcase" / "video.mp4"
    scenario = video.parent / "scenario.json" if given is None else given / "scenario.json"
    if given is None:
        showcase_tool("gen-video", "--out", str(video), "--frames", str(SHOWCASE_FRAMES))
    showcase_tool("gen-config", "--video", str(video), "--weights",
                  str(ROOT / "docs" / "artifacts" / "detr_small_weights.npz"), "--out", str(tmp / "showcase.yaml"),
                  "--out-dir", str(tmp / "showcase_card"), "--size", "small", "--score-mode", "sigmoid",
                  "--conf", "0.2", "--nms", "0.3", "--device", "cuda")
    cfg = yaml.safe_load((tmp / "showcase.yaml").read_text())
    cfg["detection"]["dtype"] = "float32"  # the CPU run's type, so that card and CPU are held to each other
    if given is None:
        rc, counts, secs, card = run_main(ka, probe, cfg, tmp / "showcase_card.yaml")
    else:
        card = resumable_copy(given / "session", tmp / "showcase_card" / "given")
        rc, counts, secs, _ = run_main(ka, probe, cfg, tmp / "showcase_card.yaml", "--resume", str(card))
    check(rc == 0, f"11b: main exited {rc} on the card")
    frames = len((card / "03_tracking" / "frames_index.csv").read_text().splitlines()) - 1
    chunks = math.ceil(frames / cfg["detection"]["batch_size"])
    want = launches(whole_kv=9 * chunks)  # DETR-small: 3 encoder and 3+3 decoder calls a chunk, all K1
    check(counts == want, f"11b: main launched {counts} on the card, expected {want} ({chunks} chunks)")
    check(sum(probe.failed_chunks) == 0, f"11b: {sum(probe.failed_chunks)} chunks raised")

    cpu_cfg = json.loads(json.dumps(cfg))
    cpu_cfg["detection"]["device"] = "cpu"
    cpu_cfg["output"]["directory"] = str(tmp / "showcase_cpu")
    cpu = resumable_copy(card, tmp / "showcase_cpu" / card.name)
    rc, cpu_counts, cpu_secs, session = run_main(ka, probe, cpu_cfg, tmp / "showcase_cpu.yaml", "--resume", str(cpu))
    check(rc == 0 and session == cpu and cpu_counts == launches(), f"11b: the CPU run exited {rc}, {cpu_counts}")

    showcase_tool("gold-gt", "--session", str(card), "--scenario", str(scenario), "--out", str(tmp / "gold.json"))
    gt = load_gold_gt(tmp / "gold.json")
    got = {}
    for name, s in (("card", card), ("cpu", cpu)):
        pred = load_mot_csv(s / "03_tracking" / "tracks_mot.csv")
        got[name] = {**evaluate_mot(gt, pred).to_dict(), "hota": evaluate_hota(gt, pred).hota}
    gap = {k: abs(got["card"][k] - got["cpu"][k]) for k in ("mota", "idf1")}
    check(max(gap.values()) <= SHOWCASE_SCORE_TOL,
          f"11b: card {got['card']} against CPU {got['cpu']}: MOTA/IDF1 apart by {gap} (bar {SHOWCASE_SCORE_TOL})")

    rows_equal, left, zone_rows = check_showcase_sessions(card, cpu, frames)
    card_summary = json.loads((card / "summary.json").read_text())
    phase25 = {k: json.loads((s / "summary.json").read_text())["performance"]["03_tracking"]["total_time"]
               for k, s in (("card", card), ("cpu", cpu))}
    log(f"[11b] showcase (tools/e2e_showcase.py, {SHOWCASE_FRAMES} video frames, {frames} on the 60 s grid), DETR-small "
        f"checkpoint float32 224x384 conf 0.2 NMS 0.3, {'video made here' if given is None else f'Phase 1 of {given}'}, "
        f"cascade: card " + ", ".join(
            f"{k} {got['card'][k]:.4f}" for k in ("mota", "idf1", "hota")) + f"; CPU " + ", ".join(
            f"{k} {got['cpu'][k]:.4f}" for k in ("mota", "idf1", "hota"))
        + f" (port mot_metrics against the gold GT); card IDSW {got['card']['id_switches']}, FP "
        f"{got['card']['false_positives']}, FN {got['card']['false_negatives']} of {got['card']['num_objects']}")
    log(f"[11b] tracks_mot.csv: {rows_equal} matched rows with the same id, {left} rows in one run only (within "
        f"1e-3 of a threshold); zone_counts.csv {len(zone_rows)} rows, one a 5-minute window, each counting a "
        f"track id once; card launches {counts} ({chunks} chunks); Phase 2.5 seconds (summary.json): card "
        f"{phase25['card']:.3f}, CPU {phase25['cpu']:.3f}; main card {secs:.3f} s "
        f"({phase_seconds(card_summary)}), CPU phases 2-5 {cpu_secs:.3f} s, on {smi}")
    return {"counts": counts, "scores": got, "phase25": phase25,
            "mot": {"gt_format": "gold", "gt": (tmp / "gold.json").read_text(),
                    "pred": (card / "03_tracking" / "tracks_mot.csv").read_text(),
                    "what": "[11b]'s tracks_mot.csv (the showcase on the card) and its gold GT"}}


def load_threshold(scores_valid: list) -> float:
    """The confidence threshold that leaves the most frames within
    LOAD_DETECTIONS detections (ties: the median nearest the middle), from
    each frame's scores at threshold 0 (NMS keeps a box by the boxes scored
    above it only, so raising the threshold keeps the rest of that run's
    boxes)."""
    lo, hi = LOAD_DETECTIONS
    target = (lo + hi) // 2
    per_frame = [np.sort(s)[::-1] for s in scores_valid]
    check(all(len(s) >= lo for s in per_frame), f"11c: a frame has only {min(len(s) for s in per_frame)} boxes at 0.0")
    cands = sorted({float(s[min(target, len(s)) - 1]) for s in per_frame})
    def spread(t):
        n = [int((s >= t).sum()) for s in per_frame]
        return sum(not lo <= k <= hi for k in n), abs(np.median(n) - target)
    return min(cands, key=spread)


def person_head(detector) -> None:
    """Every class but person (and no-object) of the detector's class head
    gets a zero weight row and a bias of -20, so that person is each query's
    top class and its score is the random model's own."""
    head = detector.model.class_labels_classifier
    others = [c for c in range(head.out_features - 1) if c != detector.detr_config.person_class_id]
    with torch.no_grad():
        head.weight[others] = 0.0
        head.bias[others] = -20.0


def full_width_tracking_phase(ka, smi: str, frames: list, stamps: list) -> dict:
    """[11c]: DETR-R50 bf16 at 736x1280, batch 8, seeded random weights,
    over [8a]'s frames: DetectionPhase, TrackingPhase (cascade, then scan on
    the card), TransformPhase and AggregationPhase (8a's load homography and
    zones); the scan's ids equal to the port's scan on the CPU over the same
    detections and features."""
    H, zones = LOAD_H, LOAD_ZONES
    import copy

    from office_person_detection_vit_torch.core.dto import FrameResult
    from office_person_detection_vit_torch.pipeline.phases import DetectionPhase, TrackingPhase
    from office_person_detection_vit_torch.tracking.scan_tracker import assign_track_ids

    n = len(frames)
    cfg = {"detection.model_size": "full", "detection.dtype": "bfloat16", "detection.device": "cuda",
           "detection.batch_size": 8, "detection.input_height": 736, "detection.input_width": 1280,
           "detection.score_mode": "sigmoid", "detection.confidence_threshold": 0.0, "detection.nms_threshold": 0.4,
           "tracking.enabled": True,
           "transform.method": "homography", "homography.matrix": H.tolist(), "zones": zones}
    scout = DetectionPhase(cfg)
    scout.initialize()
    person_head(scout.detector)
    batch = scout.detector.detect_batch(np.stack(frames))
    kept = [s[v] for s, v in zip(batch.scores, batch.valid)]
    if min(len(k) for k in kept) < LOAD_DETECTIONS[0]:  # NMS 0.4 leaves too few of the random boxes
        cfg["detection.nms_threshold"] = None
        scout.detector.nms_threshold = None
        batch = scout.detector.detect_batch(np.stack(frames))
        kept = [s[v] for s, v in zip(batch.scores, batch.valid)]
    thr = load_threshold(kept)
    scout.cleanup()
    cfg["detection.confidence_threshold"] = thr
    detection = DetectionPhase(cfg)
    detection.initialize()
    person_head(detection.detector)
    detection.detector.detect_batch(np.stack(frames[:8]))  # warm-up
    results = [FrameResult(i, ts) for i, ts in enumerate(stamps)]
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        torch.cuda.synchronize()
        ka.reset_launch_counts()
        t = time.perf_counter()
        detection.execute(frames, results, out)
        torch.cuda.synchronize()
        secs["detection"] = time.perf_counter() - t
        counts = dict(ka.launch_counts)
        per = [len(r.detections) for r in results]
        lo, hi = LOAD_DETECTIONS
        in_range = sum(lo <= k <= hi for k in per) / n
        check(lo <= np.median(per) <= hi, f"11c: detections a frame {min(per)}-{max(per)}, median "
              f"{np.median(per)}, at threshold {thr}")
        want = expected_launches(ka, 920, torch.bfloat16, n // 8)
        check(counts == want and counts["attention_flash"] == 18 * (n // 8),
              f"11c: the detection phase launched {counts}, expected {want} (18 K2 a chunk)")
        engines = {}
        for engine in ("cascade", "scan"):
            runs = copy.deepcopy(results) if engine == "scan" else results
            phase = TrackingPhase({**cfg, "tracking.engine": engine})
            phase.set_detector(detection.detector)
            torch.cuda.synchronize()
            t = time.perf_counter()
            phase.execute(runs, frames, out / engine, detection_batch=detection.last_batch)
            torch.cuda.synchronize()
            secs[f"tracking ({engine})"] = time.perf_counter() - t
            width = detection.detector.detr_config.d_model
            check(all(d.feature is not None and d.feature.shape == (width,) for r in runs for d in r.detections),
                  f"11c: {engine}: a detection without its {width}-d encoder feature")
            check(phase.statistics["unique_tracks"] > 0, f"11c: {engine}: no track ({phase.statistics})")
            engines[engine] = (runs, phase.statistics)
        scan_runs = engines["scan"][0]
        card_ids = [[d.track_id for d in r.detections] for r in scan_runs]
        cpu_runs = copy.deepcopy(scan_runs)
        assign_track_ids(cpu_runs, device="cpu")
        check(card_ids == [[d.track_id for d in r.detections] for r in cpu_runs],
              "11c: the scan's ids on the card differ from the port's scan on the CPU")
        phase_secs, _ = run_phases(cfg, results, out)
        secs.update(phase_secs)
        check_artifacts(out, [z["id"] for z in zones], n)
    log(f"[11c] full width into tracking: {n} frames, DETR-R50 bf16 736x1280 batch 8, seeded random weights, "
        f"threshold {thr:.6f}, NMS {cfg['detection.nms_threshold']} (set from the scores at 0.0; a load, not a test "
        f"of quality): {min(per)}-{max(per)} detections a frame, median {np.median(per):.0f}, {100 * in_range:.1f}% "
        f"of frames within {lo}-{hi} ({sum(per)} in all), each with its 256-d ROI-pooled encoder feature; launches "
        f"{counts} (18 K2 a chunk); sigmoid scores, person the top class of every query (person_head); cascade {engines['cascade'][1]}; scan {engines['scan'][1]}, its "
        f"ids equal to the port's CPU scan on the same detections and features")
    log(f"[11c] wall seconds (host clock, card synchronised): " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
        + f" on {smi}")
    return counts


def tracking_slice(ka, probe, smi: str, frames: list, stamps: list, showcase: Path | None = None) -> dict:
    """Phase 11: the tracking slice on the card; ``frames`` and ``stamps``
    are 8a's load, ``probe`` the FlowProbe of phase 9, ``showcase`` [11b]'s
    session made elsewhere (``showcase_phase``), if any."""
    t = time.perf_counter()
    workday = workday_phase(smi)
    with tempfile.TemporaryDirectory() as tmp:
        showcase = showcase_phase(ka, probe, smi, Path(tmp), showcase)
    load_counts = full_width_tracking_phase(ka, smi, frames, stamps)
    log(f"[11] tracking phase {time.perf_counter() - t:.1f} s")
    return {"workday": workday, "showcase": showcase, "load": load_counts}


# ------------------------------------------------------------------ phase 12
# The ViT slice: ViT-base/16 (hidden 768, 12 layers of 12 heads, head dim 64,
# MLP 3072, native grid 14; models/vit.py) as the DETR backbone at the
# detector's full size. At 736x1280 the ViT sees 46 x 80 patches and the CLS
# token, 3681 tokens, and DETR's encoder the 3680 patches; at 768x1344
# training, 48 x 84 + 1 = 4033. Each chunk (training step) makes 30 attention
# calls: 12 ViT (D 64, no mask), 6 encoder, 6 cross, 6 decoder self (D 32).
VIT_CALLS = 30
VIT_DETECT = (8, 12, 46 * 80 + 1, 46 * 80 + 1, 64)
VIT_TRAIN = (8, 12, 48 * 84 + 1, 48 * 84 + 1, 64)
# [12a]: the forward kernels at head dim 64 and at a padded 48, both types,
# at [2]'s bars (attention_kernel_bench.TOLERANCE): the ViT's main-path shape
# (bf16 K2), the same in float32, ViT-base at 224x224 (197 tokens, where K1's
# block fits), and head dim 48 padded to 64.
VIT_KERNEL_CASES = [
    ("attention_flash", VIT_DETECT, "bfloat16", False, "ViT-base/16 self-attention at 736x1280, batch 8 (main path)"),
    ("attention_flash", (1, 12, 3681, 3681, 64), "float32", False, "the same in float32, batch 1"),
    ("attention_whole_kv", (8, 12, 197, 197, 64), "bfloat16", False, "ViT-base at 224x224, K1's bf16 body"),
    ("attention_whole_kv", (8, 12, 197, 197, 64), "float32", False, "ViT-base at 224x224, float32"),
    ("attention_flash", (2, 12, 3681, 3681, 48), "bfloat16", True, "head dim 48, padded to 64"),
    ("attention_flash", (2, 8, 920, 920, 48), "float32", True, "head dim 48, float32 K2"),
    ("attention_whole_kv", (2, 8, 197, 197, 48), "float32", True, "head dim 48, float32 K1"),
]
# [12a]: B.4 at [10a]'s gate at head dim 64 (ViT-base training, batch 1 so
# that float64 autograd fits beside it; ViT at 224x224 in float32) and 48.
VIT_B4_CASES = [((1, 12, 4033, 4033, 64), "bfloat16", False, "ViT-base training 768x1344, batch 1"),
                ((2, 12, 197, 197, 64), "float32", False, "ViT-base 224x224 float32 (K1)"),
                ((2, 4, 300, 260, 48), "bfloat16", True, "head dim 48, padded to 64"),
                ((2, 4, 300, 260, 48), "float32", True, "head dim 48 float32")]
VIT_LSE_CASES = VIT_B4_CASES + [(VIT_DETECT, "bfloat16", False, "ViT detect")]
def vit_kernels_phase(ka, build, smi: str) -> dict:
    """[12a]: [1]'s readings of every head-dim-64 body (no spill allowed),
    the forward kernels at VIT_KERNEL_CASES, B.4 at VIT_B4_CASES, and B.4 at
    ViT-base's full training shape timed against SDPA and the bound."""
    from office_person_detection_vit_torch import attention_kernel_bench as abench

    counts = sass_counts(build)
    for a in ka.kernel_attributes():
        if a["name"].endswith(",64>"):
            ops = check_tensor_cores(a, ops_of(counts, a["name"]), "12a")
            check(a["local_bytes"] == 0, f"12a: {a['name']} spills {a['local_bytes']} B a thread")
            log(f"[12a] {a['name']:36s} regs {a['regs']:3d}  spill (local) {a['local_bytes']} B  {ops}")
    rows = {}
    for seed, case in enumerate(VIT_KERNEL_CASES):
        row = abench.measure(ka, case, 500 + seed)
        log(f"[12a] {abench.describe(row)} [{case[4]}]")
        rows[case[:3]] = row
        torch.cuda.empty_cache()
    b4_phase(ka, smi, VIT_B4_CASES, VIT_LSE_CASES, tag="12a")
    return {"forward": rows, "b4": vit_b4_timing(ka, smi)}


def vit_b4_timing(ka, smi: str, shape=VIT_TRAIN, tag: str = "12a", seed: int = 600,
                  what: str = "ViT-base training at 768x1344, batch 8") -> dict:
    """[12a]: B.4 at a ViT's training shape (ViT-base's VIT_TRAIN by
    default) in bf16: the gradients against the pair's plain version
    (B4_BAR) and the forward against the plain version in float32 (the
    bench's TOLERANCE), then the times of forward+backward, the forward,
    plain autograd and SDPA (forward+backward and its forward alone), and the
    pair beside its plain version, SDPA's backward and its bound
    (attention_kernel_bench.measure_backward, on the same inputs)."""
    from office_person_detection_vit_torch import attention_kernel_bench as abench
    from office_person_detection_vit_torch.ops import attention as oa
    from office_person_detection_vit_torch.ops.attention import (KernelAttention, attention_backward_reference,
                                                                 attention_reference)

    dtype = torch.bfloat16
    q, k, v, _ = abench.make_inputs(shape, dtype, False, seed)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(seed + 1)).to("cuda", dtype)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    oa.reset_launch_counts()
    ka.reset_launch_counts()
    out = KernelAttention.apply(q, k, v, None)
    grads = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
    torch.cuda.synchronize()
    check(oa.launch_counts["attention_diff"] == 1 and ka.launch_counts == launches(flash=1, backward=1),
          f"{tag}: B.4 at {shape} launched {oa.launch_counts}, {ka.launch_counts}")
    x = [t.detach() for t in (q, k, v)]
    twin = attention_backward_reference(*x, None, *ka.attention_flash(*x, None, with_lse=True), g)
    twin_err = relative_error(grads, twin)
    grad_abs = max((a.float() - b.float()).abs().max().item() for a, b in zip(grads, twin))
    del twin
    check(all(bool(torch.isfinite(t).all()) for t in (out, *grads)) and twin_err <= B4_BAR[dtype],
          f"{tag}: B.4 at {shape}: gradients {twin_err:.2e} from the pair's plain version (bar {B4_BAR[dtype]:.2e})")
    with torch.no_grad():  # the forward against the plain version in float32, a batch entry at a time
        fwd_err = max((out[b].float() - attention_reference(*(t[b:b + 1].float() for t in x))[0]).abs().max().item()
                      for b in range(shape[0]))
    check(fwd_err <= abench.TOLERANCE[dtype],
          f"{tag}: B.4's forward at {shape}: max|err| {fwd_err:.2e} from the plain version in float32 "
          f"(tol {abench.TOLERANCE[dtype]:.0e})")

    def fwd_bwd(fn):
        def run():
            torch.autograd.grad(fn(q, k, v, None), (q, k, v), g)
        return run

    def sdpa(q, k, v, mask):
        return torch.nn.functional.scaled_dot_product_attention(q, k, v)

    b_ms, b_by = b4_bound(shape, dtype, None)
    f_ms, f_by = abench.bound(shape, dtype, None)
    row = {
        "shape": list(shape), "dtype": "bfloat16", "max_abs_err": grad_abs, "grad_err_vs_twin_rel": twin_err,
        "forward_max_abs_err": fwd_err,
        "ms": abench.cuda_ms(fwd_bwd(KernelAttention.apply), 5, 2),
        "forward_ms": abench.cuda_ms(lambda: KernelAttention.apply(*x, None), 5, 2),
        "backward_ms": abench.cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True), 5, 2),
        "plain_ms": abench.cuda_ms(fwd_bwd(attention_reference), 2, 1),
        "library_ms": abench.cuda_ms(fwd_bwd(sdpa), 5, 2),
        "library_forward_ms": abench.cuda_ms(lambda: sdpa(*x, None), 5, 2),
        "bound_ms": b_ms, "bound_by": b_by, "forward_bound_ms": f_ms, "forward_bound_by": f_by,
    }
    del out, grads
    pair = abench.measure_backward(ka, (tuple(shape), "bfloat16", what), seed, iters=5)
    row.update(pair_ms=pair["ms"], pair_host_us=pair["host_us"], pair_err_vs_twin_rel=pair["max_rel_err"],
               plain_backward_ms=pair["plain_ms"], library_backward_ms=pair["library_ms"],
               backward_bound_ms=pair["bound_ms"], backward_bound_by=pair["bound_by"])
    bb_ms, bb_by = pair["bound_ms"], pair["bound_by"]
    log(f"[{tag}] B.4 {shape} bf16 ({what}): gradients {twin_err:.2e} from the pair's "
        f"plain version (bar {B4_BAR[dtype]:.2e}), the forward {fwd_err:.2e} from the plain version "
        f"(tol {abench.TOLERANCE[dtype]:.0e}); forward+backward {row['ms']:.4f} ms (forward {row['forward_ms']:.4f}, "
        f"backward {row['backward_ms']:.4f}, the pair alone {row['pair_ms']:.4f}), plain autograd {row['plain_ms']:.4f}, "
        f"the pair's plain version {row['plain_backward_ms']:.4f}, SDPA {row['library_ms']:.4f} (forward "
        f"{row['library_forward_ms']:.4f}, backward {row['library_backward_ms']:.4f}); bound {b_ms:.4f} ({b_by}; "
        f"{100 * b_ms / row['ms']:.1f}% of it), the forward's {f_ms:.4f}, the backward's {bb_ms:.4f} ({bb_by}, "
        f"{100 * bb_ms / row['pair_ms']:.1f}% of the pair) on {smi}")
    del q, k, v, g, x
    torch.cuda.empty_cache()
    return row


def vit_detector_config(device: str = "cuda") -> dict:
    """DETRDetector's keys for ViT-base/16 DETR at its full size, bf16, batch 8, 736x1280."""
    return {"backbone": "vit", "patch_size": 16, "model_size": "full", "dtype": "bfloat16", "device": device,
            "batch_size": 8, "input_height": 736, "input_width": 1280, "confidence_threshold": 0.5,
            "nms_threshold": 0.4}


def vit_detect_phase(ka, probe, smi: str, frames: np.ndarray, videos: Path, tmp: Path) -> dict:
    """[12b]: ViT-base/16 DETR (seeded random weights) through
    DETRDetector.detect_batch at full width, bf16, batch 8 (30 K2 a chunk,
    frames/s), the float32 model on the card against the CPU at batch 1 at
    the repo's DETR bar, and ``main`` with ``detection.backbone: vit`` on the
    one-hour video."""
    from office_person_detection_vit_torch.detection.detector import DETRDetector
    from office_person_detection_vit_torch.models.detr import DETRConfig

    det = DETRDetector({f"detection.{k}": v for k, v in vit_detector_config().items()})
    det.load_model()
    check(det.feature_stride == 16 and det.feature_hw == (46, 80), f"12b: feature grid {det.feature_hw}")
    det.detect_batch(frames[:8])  # warm-up
    torch.cuda.synchronize()
    ka.reset_launch_counts()
    batch = det.detect_batch(frames[:16])
    counts = dict(ka.launch_counts)
    check(det.last_failed_chunks == 0 and batch.boxes_xywh.shape == (16, 100, 4), "12b: ViT detect failed")
    check(all(np.isfinite(a).all() for a in (batch.boxes_xywh, batch.scores, batch.foot)), "12b: non-finite detections")
    check(counts == launches(flash=VIT_CALLS * 2), f"12b: ViT detect launched {counts}, expected {VIT_CALLS} K2 x 2 chunks")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        det.detect_batch(frames[:16])
        times.append(time.perf_counter() - t)
    fps = sorted(16 / t for t in times)
    log(f"[12b] ViT-base/16 DETR bf16 736x1280 batch 8 (3681 ViT tokens, 3680 encoder tokens): launches {counts} over "
        f"2 chunks ({VIT_CALLS} K2 a chunk); {fps[-1]:.2f} frames/s best, {fps[1]:.2f} median, {fps[0]:.2f} worst "
        f"(3 runs x 16 frames, host clock, uint8 frames in) on {smi}")
    det.cleanup()
    del det
    torch.cuda.empty_cache()

    # 12 ViT + 12 DETR calls at 3680-3681 keys take K2 in float32, the 6 decoder self-attentions K1
    d_logits, d_boxes, cpu_secs = float32_card_vs_cpu(ka, DETRConfig(dtype="float32", backbone="vit"), frames[:1],
                                                      launches(whole_kv=6, flash=24), "12b")
    log(f"[12b] float32 ViT-base/16 DETR at 736x1280, batch 1, on the card (K1 x6, K2 x24) vs the CPU (plain, "
        f"{cpu_secs:.1f} s): max|dlogits| {d_logits:.2e} (atol {LOGITS_ATOL} rtol {LOGITS_RTOL}), "
        f"max|dboxes| {d_boxes:.2e} (atol {BOXES_ATOL})")
    torch.cuda.empty_cache()

    n = 13  # the one-hour video's 5-minute targets
    cfg = flow_config(videos / "hour.mp4", tmp / "vit_out", vit_detector_config(), np.eye(3), hour_zones())
    rc, main_counts, secs, session = run_main(ka, probe, cfg, tmp / "vit.yaml")
    check(rc == 0, f"12b: main with detection.backbone vit exited {rc}")
    summary = check_session(session, list(HOUR_QUADS), n, "12b")
    check(sum(probe.failed_chunks) == 0, f"12b: {sum(probe.failed_chunks)} chunks raised")
    check(main_counts == launches(flash=VIT_CALLS * 2),
          f"12b: main launched {main_counts}, expected {VIT_CALLS} K2 x 2 chunks ({n} frames, batch 8)")
    log(f"[12b] main with detection.backbone vit (ViT-base/16, bf16, batch 8) on the one-hour video: {n} frames, "
        f"launches {main_counts}; phase seconds {phase_seconds(summary)}; main {secs:.3f} s (host clock) on {smi}")
    return {"main_counts": main_counts, "detect_counts": counts, "fps_median": fps[1], "session": session}


def vit_train_phase(ka, smi: str, data: Path, tmp: Path) -> dict:
    """[12c]: ViT-base/16 DETR training at 768x1344, bf16 (float32 master
    weights), batch 8: [10b]'s harness (2 warm-up + 6 timed steps, the split
    of a step, every loss finite, every parameter with a gradient moved, 30
    B.4 pairs a step), then ``train_detr --backbone vit`` for one epoch."""
    from office_person_detection_vit_torch import train_detr
    from office_person_detection_vit_torch.models.detr import DETRConfig
    from office_person_detection_vit_torch.models.weights import flax_param_map
    from office_person_detection_vit_torch.ops import attention as oa

    samples = train_detr.load_coco_dataset(data / "train" / "images", data / "train" / "coco.json")
    cfg = DETRConfig(dtype="bfloat16", dropout=0.1, backbone="vit")
    full = train_full_width(ka, smi, samples, cfg, tag="12c", calls=VIT_CALLS, leaves=len(flax_param_map(cfg)),
                            name="ViT-base/16 DETR")
    out = tmp / "vit_train"
    argv = ["--images", str(data / "train" / "images"), "--annotations", str(data / "train" / "coco.json"),
            "--backbone", "vit", "--epochs", "1", "--batch", str(TRAIN_BATCH), "--height", str(TRAIN_HW[0]),
            "--width", str(TRAIN_HW[1]), "--checkpoint", str(out), "--device", "cuda", "--augment"]
    ka.reset_launch_counts()
    oa.reset_launch_counts()
    t = time.perf_counter()
    rc = train_detr.main(argv)
    secs = time.perf_counter() - t
    steps = TRAIN_IMAGES // TRAIN_BATCH
    counts = {**ka.launch_counts, "attention_diff": oa.launch_counts["attention_diff"]}
    history = json.loads((out / "history.json").read_text())
    check(rc == 0 and len(history["step_losses"]) == steps and all(map(math.isfinite, history["step_losses"])),
          f"12c: train_detr --backbone vit exited {rc}, losses {history.get('step_losses')}")
    check(counts == {**launches(flash=VIT_CALLS * steps, backward=VIT_CALLS * steps), "attention_diff": VIT_CALLS * steps},
          f"12c: train_detr --backbone vit launched {counts}, expected {VIT_CALLS} B.4 pairs a step x {steps}")
    log(f"[12c] train_detr --backbone vit (ViT-base/16, bf16, 768x1344, batch {TRAIN_BATCH}, augment), one epoch of "
        f"{steps} steps: exit 0 in {secs:.3f} s (build of the model and first steps included), launches {counts}, "
        f"losses {[round(x, 4) for x in history['step_losses']]} on {smi}")
    return {"full": full, "entry_counts": counts}


def hour_ground_truth(session: Path, path: Path) -> int:
    """A COCO file of the persons drawn into each frame of ``session``'s
    one-hour video (write_video draws hour_people(frame); a person at (x, y)
    is the box (x, y - 26, 50, 156)), keyed by the saved frames' names.
    Returns the number of boxes."""
    rows = list(csv.reader((session / "01_extraction" / "extraction_results.csv").open()))[1:]
    images, annotations = [], []
    for i, r in enumerate(rows):
        images.append({"id": i, "file_name": Path(r[-1]).name, "width": 1280, "height": 720})
        for x, y, _ in hour_people(int(r[0])):
            annotations.append({"id": len(annotations), "image_id": i, "bbox": [x, y - 26, 50, 156],
                                "category_id": 1})
    path.write_text(json.dumps({"images": images, "annotations": annotations,
                                "categories": [{"id": 1, "name": "person"}]}))
    return len(annotations)


def vit_eval_phase(ka, probe, smi: str, session: Path, videos: Path, tmp: Path) -> dict:
    """[12d]: detection evaluation with the committed DETR-small checkpoint
    against hour_ground_truth: ``main --evaluate`` (phases 2-6 of a copy of
    [12b]'s session resumed after 01_extraction) and the trainer's
    ``--evaluate`` (the baseline score before training) on the same frames,
    each on the card and on the CPU; card tp/fp/fn within 1 of the CPU's.
    The trainer scores before its first epoch (its baseline) and writes
    ``history.json`` at an epoch's end, so it trains one epoch here and the
    baseline is read."""
    from office_person_detection_vit_torch import train_detr

    gt = tmp / "hour_gt.json"
    n_gt = hour_ground_truth(session, gt)
    ckpt = ROOT / "docs" / "artifacts" / "detr_small_weights.npz"
    detection = {"model_size": "small", "score_mode": "sigmoid", "dtype": "float32", "input_height": 224,
                 "input_width": 384, "confidence_threshold": 0.2, "nms_threshold": 0.3, "batch_size": 1,
                 "checkpoint_path": str(ckpt)}
    results = {}
    for device in ("cuda", "cpu"):
        copy = resumable_copy(session, tmp / f"eval_{device}" / session.name)
        cfg = flow_config(videos / "hour.mp4", copy.parent, dict(detection, device=device), np.eye(3), hour_zones())
        cfg["evaluation"] = {"ground_truth_path": str(gt), "iou_threshold": 0.5}
        rc, counts, secs, got = run_main(ka, probe, cfg, tmp / f"eval_{device}.yaml", "--resume", str(copy), "--evaluate")
        check(rc == 0 and got == copy, f"12d {device}: main --resume --evaluate exited {rc}")
        main_metrics = json.loads((copy / "evaluation" / "evaluation_metrics.json").read_text())
        argv = ["--images", str(session / "01_extraction" / "frames"), "--annotations", str(gt), "--model-size",
                "small", "--class-loss", "focal", "--init", str(ckpt), "--epochs", "1", "--evaluate",
                "--eval-conf", "0.2", "--eval-nms", "0.3", "--height", "224", "--width", "384", "--batch", "8",
                "--device", device, "--checkpoint", str(tmp / f"train_eval_{device}")]
        check(train_detr.main(argv) == 0, f"12d {device}: train_detr --evaluate failed")
        evals = json.loads((tmp / f"train_eval_{device}" / "history.json").read_text())["evals"]
        check([e["epoch"] for e in evals] == [0, 1], f"12d {device}: train_detr --evaluate scored {evals}")
        train_metrics = evals[0]
        results[device] = {"main": main_metrics, "train": train_metrics, "launches": counts}
    for run in ("main", "train"):
        card, cpu = results["cuda"][run], results["cpu"][run]
        off = {k: abs(card[k] - cpu[k]) for k in ("true_positives", "false_positives", "false_negatives")}
        check(max(off.values()) <= 1, f"12d {run} --evaluate: card {card} vs CPU {cpu}")
        check(card["true_positives"] + card["false_negatives"] == n_gt, f"12d {run}: {card} over {n_gt} GT boxes")
        log(f"[12d] {run} --evaluate, DETR-small checkpoint on the one-hour video's {n_gt} drawn persons: card "
            f"tp/fp/fn {card['true_positives']}/{card['false_positives']}/{card['false_negatives']} (precision "
            f"{card['precision']:.4f}, recall {card['recall']:.4f}), CPU {cpu['true_positives']}/"
            f"{cpu['false_positives']}/{cpu['false_negatives']}; within {max(off.values())} (bar 1)"
            + (f"; AP@50 card {card['ap_50']:.4f}, CPU {cpu['ap_50']:.4f}" if run == "train" else ""))
    return results


def vit_slice(ka, build, probe, smi: str, frames: np.ndarray, videos: Path, data: Path) -> dict:
    """Phase 12: the ViT slice on the card."""
    t = time.perf_counter()
    kernels = vit_kernels_phase(ka, build, smi)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        detect = vit_detect_phase(ka, probe, smi, frames, videos, tmp)
        train = vit_train_phase(ka, smi, data, tmp)
        evaluation = vit_eval_phase(ka, probe, smi, detect["session"], videos, tmp)
    log(f"[12] ViT phase {time.perf_counter() - t:.1f} s")
    return {"kernels": kernels, "detect": detect, "train": train, "eval": evaluation}


def vit_kernel_rows(vit: dict) -> list:
    """The kernels line's rows of the head-dim-64 path: K2 at the ViT's
    shape beside its launches through main ([12b]), B.4 and its backward
    pair at ViT-base's training shape beside their launches in [12c]."""
    src = "office_person_detection_vit_torch/csrc/attention.cu"
    k2 = vit["kernels"]["forward"][VIT_KERNEL_CASES[0][:3]]
    b4 = vit["kernels"]["b4"]
    steps = vit["train"]["full"]["counts"]
    train_path = "ViT-base/16 DETR bf16 training at 768x1344, batch 8, 6 timed steps, phase 12c"
    return [
        {"name": "attention_flash_d64", "route": "cuda", "source": src, "body": "attention_flash_wgmma<bf16,64>",
         "replaces": "office_person_detection_vit_tpu/ops/attention.py:159",
         "launches": vit["detect"]["main_counts"]["attention_flash"],
         "launches_on": "ViT-base/16 DETR bf16 through main on the one-hour video, 13 frames, phase 12b",
         **{k: k2[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
                               "dtype", "instruction")}},
        {"name": "attention_diff_d64", "route": "cuda", "source": src,
         "body": "attention_flash_wgmma<bf16,64> + attention_bwd_dq_wgmma<bf16,64> + attention_bwd_dkdv_wgmma<bf16,64>",
         "function": "office_person_detection_vit_torch/ops/attention.py KernelAttention",
         "replaces": "office_person_detection_vit_tpu/ops/attention.py:306", "launches": steps["attention_diff"],
         "launches_on": train_path,
         **{k: b4[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "forward_ms",
                               "backward_ms", "shape", "dtype")}},
        {"name": "attention_backward_d64", "route": "cuda", "source": src,
         "body": "attention_bwd_dq_wgmma<bf16,64> + attention_bwd_dkdv_wgmma<bf16,64>",
         "replaces": "office_person_detection_vit_tpu/ops/attention.py:322", "launches": steps["attention_backward"],
         "launches_on": train_path, "max_abs_err": b4["max_abs_err"], "ms": b4["pair_ms"],
         "plain_ms": b4["plain_backward_ms"], "bound_ms": b4["backward_bound_ms"],
         "bound_by": b4["backward_bound_by"], "library_ms": b4["library_backward_ms"], "shape": b4["shape"],
         "dtype": b4["dtype"]},
    ]


# ------------------------------------------------------------------ phase 13
# C.7: head dims up to 128. [13a] holds every D-128 body against the plain
# version at [2]'s bars (attention_kernel_bench.TOLERANCE) and B.4 at
# [10a]'s gate: ViT-H/16's heads (hidden 1280 over 16 heads: 80, padded to
# 128) on the ViT detect's 3681 tokens, head dim 128 there, K1 at ViT-H's
# 224x224 (197 tokens) in float32, B.4 at ViT-H's training tokens (4033,
# batch 1 so that float64 autograd fits beside it; batch 8 is timed and held
# against the pair's plain version), and the remaining bodies (K1 bf16, K2
# float32, the float32 backward pair). The path that launches them: DETR
# with ViT-H/16's widths as its backbone, its 32 layers cut to 4 (VITH).
D128_KERNEL_CASES = [
    ("attention_flash", (8, 16, 3681, 3681, 80), "bfloat16", False,
     "ViT-H/16's heads (80, padded to 128) at 736x1280, batch 8"),
    ("attention_flash", (8, 8, 3681, 3681, 128), "bfloat16", False, "head dim 128 on the ViT detect's 3681 tokens"),
    ("attention_whole_kv", (8, 16, 197, 197, 80), "float32", False, "ViT-H/16 at 224x224, float32 (K1)"),
    ("attention_whole_kv", (8, 8, 197, 197, 128), "bfloat16", True, "K1's bf16 body at head dim 128"),
    ("attention_flash", (1, 8, 3681, 3681, 128), "float32", True, "K2's float32 body at head dim 128, batch 1"),
]
D128_B4_CASES = [((1, 16, 4033, 4033, 80), "bfloat16", False, "ViT-H/16's heads training at 768x1344, batch 1"),
                 ((8, 8, 1008, 1008, 128), "bfloat16", False, "head dim 128 at DETR-R50's training tokens"),
                 ((2, 8, 197, 197, 128), "float32", True, "head dim 128 float32 (K1, the float32 pair)"),
                 ((2, 4, 300, 260, 80), "bfloat16", True, "head dim 80, padded to 128")]
D128_LSE_CASES = D128_B4_CASES + [((8, 8, 3681, 3681, 128), "bfloat16", False, "head dim 128 detect")]
#: DETR with ViT-H/16's widths (hidden 1280, 16 heads of 80, MLP 5120) as its
#: backbone, 4 of its 32 layers: 4 ViT + 18 DETR attention calls a chunk.
VITH = dict(backbone="vit", vit_hidden=1280, vit_heads=16, vit_mlp=5120, vit_layers=4)
VITH_CALLS = 4 + 18
#: B.4's shape on that model's training path: 768x1344 (48x84 patches and the
#: class token), batch 8, ViT-H/16's 16 heads of 80.
VITH_TRAIN = (8, 16, 48 * 84 + 1, 48 * 84 + 1, 80)


def d128_count(ka, name: str) -> int:
    return ka.head_dim_counts.get((name, 128), 0)


def d128_phase(ka, build, smi: str, frames: np.ndarray, samples: list) -> dict:
    """[13a]: [1]'s readings of every head-dim-128 body (no spill allowed);
    the forward cases and B.4 at [10a]'s gate; then the D-128 bodies on a
    model's path: the ViT-H-width DETR through DETRDetector.detect_batch
    (bf16, 736x1280, batch 8: K2), its float32 forward at 224x224 on the card
    against the CPU (K1), and 8 of its bf16 training steps at 768x1344 (B.4)."""
    from office_person_detection_vit_torch import attention_kernel_bench as abench
    from office_person_detection_vit_torch.detection.detector import DETRDetector
    from office_person_detection_vit_torch.models.detr import DETRConfig
    from office_person_detection_vit_torch.models.weights import flax_param_map

    t0 = time.perf_counter()
    counts = sass_counts(build)
    bodies = {}
    for a in ka.kernel_attributes():
        if a["name"].endswith(",128>"):
            ops = ops_of(counts, a["name"])
            check(a["local_bytes"] == 0, f"13a: {a['name']} spills {a['local_bytes']} B a thread")
            text = check_tensor_cores(a, ops, "13a")
            bodies[a["name"]] = {"regs": a["regs"], "local_bytes": a["local_bytes"], "hmma": ops["HMMA"],
                                 "hgmma": ops["HGMMA"], "utmaldg": ops["UTMALDG"]}
            log(f"[13a] {a['name']:36s} regs {a['regs']:3d}  spill (local) {a['local_bytes']} B  {text}")
    check(len(bodies) == 8, f"13a: {len(bodies)} head-dim-128 bodies, expected 8")
    rows = {}
    for seed, case in enumerate(D128_KERNEL_CASES):
        row = abench.measure(ka, case, 700 + seed)
        log(f"[13a] {abench.describe(row)} [{case[4]}]")
        rows[case[:3]] = row
        torch.cuda.empty_cache()
    b4 = b4_phase(ka, smi, D128_B4_CASES, D128_LSE_CASES, tag="13a")
    b4_path = vit_b4_timing(ka, smi, VITH_TRAIN, "13a", 800, "ViT-H/16-width training at 768x1344, batch 8")

    # The ViT-H-width DETR's detect: 4 K2 at head dim 128 and 18 at 32 a chunk.
    cfg = DETRConfig(dtype="bfloat16", **VITH)
    det = DETRDetector({f"detection.{k}": v for k, v in vit_detector_config().items()}, detr_config=cfg)
    det.load_model()
    det.detect_batch(frames[:8])  # warm-up
    torch.cuda.synchronize()
    ka.reset_launch_counts()
    ka.reset_head_dim_counts()
    batch = det.detect_batch(frames[:16])
    torch.cuda.synchronize()
    detect_counts, k2_d128 = dict(ka.launch_counts), d128_count(ka, "attention_flash")
    check(det.last_failed_chunks == 0 and all(np.isfinite(a).all() for a in (batch.boxes_xywh, batch.scores)),
          "13a: ViT-H-width detect failed or gave non-finite detections")
    check(detect_counts == launches(flash=VITH_CALLS * 2) and k2_d128 == 8,
          f"13a: ViT-H-width detect launched {detect_counts}, {k2_d128} at head dim 128 "
          f"(expected {VITH_CALLS} K2 a chunk x 2, 4 a chunk at 128)")
    log(f"[13a] DETR with ViT-H/16's widths (4 of 32 layers) bf16 736x1280 batch 8 through detect_batch: launches "
        f"{detect_counts} over 2 chunks, {k2_d128} of them K2 at head dim 128")
    det.cleanup()
    del det
    torch.cuda.empty_cache()

    # float32 at 224x224: the ViT's 197 tokens take K1 at head dim 80 -> 128
    ka.reset_head_dim_counts()
    d_logits, d_boxes, cpu_secs = float32_card_vs_cpu(ka, DETRConfig(dtype="float32", **VITH), frames[:1],
                                                      launches(whole_kv=VITH_CALLS), "13a", hw=(224, 224))
    k1_d128 = d128_count(ka, "attention_whole_kv")
    check(k1_d128 == 4, f"13a: the float32 forward launched {k1_d128} K1 at head dim 128, expected 4")
    log(f"[13a] float32 ViT-H-width DETR at 224x224 on the card (K1 x{VITH_CALLS}, {k1_d128} at head dim 128) vs the "
        f"CPU ({cpu_secs:.1f} s): max|dlogits| {d_logits:.2e} (atol {LOGITS_ATOL} rtol {LOGITS_RTOL}), max|dboxes| "
        f"{d_boxes:.2e} (atol {BOXES_ATOL})")
    torch.cuda.empty_cache()

    # B.4 at head dim 128 on a training path: 2 warm-up + 6 timed steps
    ka.reset_head_dim_counts()
    tcfg = DETRConfig(dtype="bfloat16", dropout=0.1, **VITH)
    train = train_full_width(ka, smi, samples, tcfg, tag="13a", calls=VITH_CALLS, leaves=len(flax_param_map(tcfg)),
                             name="ViT-H/16-width DETR (4 of 32 layers)")
    train_d128 = {"attention_diff": d128_count(ka, "attention_flash"),
                  "attention_backward": d128_count(ka, "attention_backward")}
    check(train_d128 == {"attention_diff": 32, "attention_backward": 32},
          f"13a: 8 training steps launched {train_d128} at head dim 128, expected 4 B.4 pairs a step")
    log(f"[13a] phase {time.perf_counter() - t0:.1f} s")
    return {"bodies": bodies, "forward": rows, "b4": b4, "b4_path": b4_path, "detect_counts": detect_counts,
            "k2_d128": k2_d128, "k1_d128": k1_d128, "train_d128": train_d128, "train": train}


# [13b]: the upload routes (ROADMAP A.4, A.9) at DETR-R50's main path: [8a]'s
# 288 frames, bf16, batch 8, seeded random weights with the person head and
# sigmoid scores of [11c], no NMS, the threshold chosen for 20-60 detections
# a frame.
ROUTE_BYTES = {"bgr": 720 * 1280 * 3, "i420": 720 * 3 // 2 * 1280, "i420d": 720 * 3 // 2 * 1280}


def median_ms(fn, n: int = 5) -> float:
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[n // 2]


def transfer_phase(ka, smi: str, frames: list, tmp: Path) -> dict:
    """[13b]: DETR-R50 bf16 at 736x1280, batch 8, over the 288 frames on each
    of bgr, i420 and i420d (i420d's detections equal to i420's bit for bit),
    the staging library's bytes equal to cv2's on every frame, the float32
    i420 forward on the card within the DETR bar of the CPU, and ``auto``'s
    race; for each route the upload bytes a chunk, the host ms of its
    conversion, and ms a chunk through detect_batch. The person-headed
    weights go to ``tmp`` for route_mains."""
    from office_person_detection_vit_torch.detection.detector import TRANSFER_FORMATS, DETRDetector
    from office_person_detection_vit_torch.models.detr import DETRConfig
    from office_person_detection_vit_torch.models.weights import save_flat_npz
    from office_person_detection_vit_torch.ops import staging

    t0 = time.perf_counter()
    weights = tmp / "detr_r50_person.npz"
    arr = np.stack(frames)
    n, chunks = len(arr), math.ceil(len(arr) / 8)
    planes = staging.bgr_to_i420(arr)
    check(np.array_equal(planes, staging.bgr_to_i420_reference(arr)),
          "13b: the staging library's I420 differs from cv2's")
    zeros = np.zeros(planes.shape[1:], np.uint8)
    conv_ms = {"bgr": 0.0, "i420": median_ms(lambda: staging.bgr_to_i420(arr[:8])),
               "i420d": median_ms(lambda: staging.i420_delta_encode(staging.bgr_to_i420(arr[:8]), zeros))}
    log(f"[13b] staging library (g++, {staging.library_path().name}): I420 of {n} frames byte-equal to cv2's; host ms "
        f"a chunk of 8 (median of 5): i420 {conv_ms['i420']:.3f}, i420 + XOR delta {conv_ms['i420d']:.3f}")
    # [11c]'s load without NMS (0.4 leaves one of the random model's near-equal boxes a frame)
    base = {"detection.model_size": "full", "detection.dtype": "bfloat16", "detection.device": "cuda",
            "detection.batch_size": 8, "detection.input_height": 736, "detection.input_width": 1280,
            "detection.score_mode": "sigmoid", "detection.nms_threshold": None,
            "detection.confidence_threshold": 0.0}
    out, threshold = {}, None
    for fmt in TRANSFER_FORMATS:
        det = DETRDetector(base | {"detection.transfer_format": fmt})
        det.load_model()
        person_head(det)
        if threshold is None:
            zero = det.detect_batch(arr[:64])
            threshold = load_threshold([s[v] for s, v in zip(zero.scores, zero.valid)])
            save_flat_npz(weights, det.model.state_dict(), det.detr_config)
        det.confidence_threshold = threshold
        det.detect_batch(arr[:8])  # warm-up (and i420d's chain)
        torch.cuda.synchronize()
        ka.reset_launch_counts()
        t = time.perf_counter()
        batch = det.detect_batch(arr)
        secs = time.perf_counter() - t
        counts = dict(ka.launch_counts)
        check(det.last_failed_chunks == 0 and counts == expected_launches(ka, 920, torch.bfloat16, chunks),
              f"13b {fmt}: {det.last_failed_chunks} chunks raised; launched {counts}")
        per_frame = batch.valid.sum(1)
        out[fmt] = {"batch": batch, "counts": counts, "ms_chunk": secs * 1e3 / chunks, "fps": n / secs,
                    "upload_bytes_chunk": 8 * ROUTE_BYTES[fmt], "host_conversion_ms_chunk": conv_ms[fmt],
                    "detections_per_frame": [int(per_frame.min()), float(per_frame.mean()), int(per_frame.max())]}
        log(f"[13b] {fmt:5s}: {n} frames in {secs:.3f} s ({n / secs:.2f} frames/s, {secs * 1e3 / chunks:.3f} ms a "
            f"chunk, host clock, the conversion included); upload {8 * ROUTE_BYTES[fmt]} B a chunk; launches {counts}; "
            f"detections a frame min/mean/max {out[fmt]['detections_per_frame']} at threshold {threshold:.6f}")
        det.cleanup()
        del det
    a, b = out["i420"]["batch"], out["i420d"]["batch"]
    check(all(np.array_equal(getattr(a, f), getattr(b, f)) for f in ("boxes_xywh", "scores", "valid", "foot")),
          "13b: i420d's detections differ from i420's")
    log(f"[13b] i420d's detections equal i420's bit for bit over {n} frames ({int(a.valid.sum())} detections)")
    race = DETRDetector(base | {"detection.transfer_format": "auto", "detection.confidence_threshold": threshold})
    race.load_model()
    race.detect_batch(arr[:16])
    pick, race_ms = race.transfer_format, race.transfer_race_ms
    check(pick in TRANSFER_FORMATS and set(race_ms) == set(TRANSFER_FORMATS), f"13b: the race kept {pick}")
    log(f"[13b] auto: the race kept {pick} (best ms a chunk of 8, host clock to the results on the host: "
        f"{', '.join(f'{k} {v:.3f}' for k, v in race_ms.items())}) on {smi}")
    race.cleanup()
    del race
    torch.cuda.empty_cache()
    d_logits, d_boxes, cpu_secs = float32_card_vs_cpu(ka, DETRConfig(dtype="float32"), arr[:2],
                                                      launches(whole_kv=6, flash=12), "13b", route="i420")
    log(f"[13b] float32 DETR-R50 through the i420 route on the card vs the CPU ({cpu_secs:.1f} s): max|dlogits| "
        f"{d_logits:.2e} (atol {LOGITS_ATOL} rtol {LOGITS_RTOL}), max|dboxes| {d_boxes:.2e} (atol {BOXES_ATOL})")
    log(f"[13b] phase {time.perf_counter() - t0:.1f} s")
    for row in out.values():
        del row["batch"]
    return {"routes": out, "race_pick": pick, "race_ms": race_ms, "threshold": threshold, "weights": weights,
            "float32_i420": {"max_dlogits": d_logits, "max_dboxes": d_boxes}}


def route_mains(ka, probe, smi: str, hour_session: Path, videos: Path, tmp: Path, weights: Path,
                threshold: float) -> dict:
    """[13b]: ``main`` on the card with DETR-R50 bf16 (transfer_phase's
    person-headed ``weights`` and ``threshold``, sigmoid scores, no NMS) on ``i420``
    and on ``i420d``, each resuming a copy of [13c]'s one-hour session after
    its Phase 1 (the OCR runs once): each session checked as 9a's, the route
    in detection_statistics.json, and the two detections.json equal byte
    for byte. bgr runs through main in 9b-12 and ``auto`` in 9a."""
    n, out, written = 13, {}, {}
    for fmt in ("i420", "i420d"):
        detection = {"model": "detr", "model_size": "full", "dtype": "bfloat16", "device": "cuda", "batch_size": 8,
                     "input_height": 736, "input_width": 1280, "checkpoint_path": str(weights),
                     "confidence_threshold": threshold, "score_mode": "sigmoid", "nms_threshold": None,
                     "transfer_format": fmt}
        cfg = flow_config(videos / "hour.mp4", tmp / f"{fmt}_out", detection, np.eye(3), hour_zones())
        copy = resumable_copy(hour_session, tmp / f"{fmt}_out" / hour_session.name)
        rc, counts, secs, session = run_main(ka, probe, cfg, tmp / f"{fmt}.yaml", "--resume", str(copy))
        check(rc == 0 and session == copy, f"13b {fmt}: main --resume exited {rc}")
        summary = check_session(session, list(HOUR_QUADS), n, f"13b {fmt}")
        want = expected_launches(ka, 920, torch.bfloat16, 2)
        check(sum(probe.failed_chunks) == 0 and probe.chunks == 2 and counts == want,
              f"13b {fmt}: main: {sum(probe.failed_chunks)} chunks raised of {probe.chunks}; launched {counts}, "
              f"expected {want}")
        stats = json.loads((session / "02_detection" / "detection_statistics.json").read_text())
        check(stats["transfer_format"] == fmt,
              f"13b {fmt}: detection_statistics.json records {stats['transfer_format']}")
        written[fmt] = (session / "02_detection" / "detections.json").read_bytes()
        out[fmt] = {"detections": stats["total_detections"], "seconds": secs, "performance": summary["performance"]}
        log(f"[13b] main with transfer_format {fmt} (DETR-R50 bf16, batch 8), resumed after the one-hour session's "
            f"Phase 1: {n} frames in {probe.chunks} chunks, {stats['total_detections']} detections, launches {counts}; "
            f"phase seconds {phase_seconds(summary)}; main {secs:.3f} s (host clock) on {smi}")
    check(written["i420"] == written["i420d"], "13b: main's detections.json differs between i420 and i420d")
    log(f"[13b] main: detections.json of i420d equal to i420's byte for byte ({out['i420']['detections']} detections)")
    return out


# [13c]: the single-shot families at full width (ROADMAP A.7b, serving):
# YOLOv8x (YOLOConfig(): variant x, person-only head) and the single-shot
# detector (SingleShotConfig(): ResNet-50, FPN head 256), bf16, 736x1280,
# batch 8, seeded random weights, the threshold chosen for 20-60 detections a
# frame. float32 on the card against the CPU at batch 1: boxes 1e-3 px and
# scores 1e-3 (the CPU sums the convolutions in another order).
SINGLE_SHOT_TOL = {"boxes": 1e-3, "scores": 1e-3}


def single_shot_config(model: str, device: str = "cuda", dtype: str = "bfloat16", **kw) -> dict:
    """The detector's keys at full width. NMS at 0.9 IoU: the random model's
    top boxes are near-equal neighbours, and the family's 0.45 keeps about 7
    of them a frame, under the load's 20-60."""
    return {"model": model, "model_size": "full", "dtype": dtype, "device": device, "batch_size": 8,
            "input_height": 736, "input_width": 1280, "confidence_threshold": 0.0, "nms_threshold": 0.9} | kw


#: The gain on YOLOv8x's seeded LeCun-normal kernels for the load: at 1.0 the
#: activations shrink tenfold a stage (C5 out about 3e-5 at 128x160, float32),
#: so every class logit is its prior bias and the scores tie; at 1.4 they stay
#: of order 1 to 7 through the 22 modules on N(0, 1) pixels (at 1.7 they reach
#: 1e5), though on a 720p frame the head's outputs spread by 20-90, where
#: sigmoid and the DFL softmax saturate.
YOLO_LOAD_GAIN = 1.4


def yolo_load_weights(det, frames: np.ndarray, factors: list | None = None) -> list:
    """The load of the seeded YOLOv8x (the analog of [11c]'s push of DETR's
    class head): every kernel times YOLO_LOAD_GAIN, then each level's box and
    class output convolution divided by the spread of its outputs less their
    bias on ``frames`` (or by ``factors``, from another device's run), so the
    scores and the DFL bins are of order 1. Returns the factors."""
    from office_person_detection_vit_torch.ops.preprocessing import preprocess_frames

    model = det.model
    heads = [getattr(model.detect, f"{branch}_{l}_2") for l in range(model.detect.levels) for branch in ("cv2", "cv3")]
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv2d):
                mod.weight.mul_(YOLO_LOAD_GAIN)
    if factors is None:
        pixels, _ = preprocess_frames(torch.from_numpy(frames).to(det.device), target_hw=det.input_hw,
                                      out_dtype=det.model_config.torch_dtype)
        with torch.inference_mode():
            levels = model(pixels)["levels"]
        outs = [lv[key] for lv in levels for key in ("box_dist", "class_logits")]
        factors = [(o - conv.bias.float()).std().item() for o, conv in zip(outs, heads)]
    with torch.no_grad():
        for conv, f in zip(heads, factors):
            conv.weight.div_(f)
    return factors


def single_shot_card_vs_cpu(model: str, frame: np.ndarray) -> dict:
    """The float32 detector on the card (TF32 off) against the same weights
    on the CPU, one frame at threshold 0, then both at the threshold midway
    between the CPU's 40th and 41st kept scores (so that no score sits on
    it): the same number of detections, each of the CPU's within
    SINGLE_SHOT_TOL of one of the card's (taken in the CPU's score order, so
    that two near-equal scores that the two devices order the other way
    still pair)."""
    from office_person_detection_vit_torch.detection import build_detector

    got, factors = {}, None
    for device in ("cpu", "cuda"):  # the load's factors from the CPU's run, for both
        det = build_detector({f"detection.{k}": v for k, v in single_shot_config(model, device, "float32").items()})
        det.load_model()
        if model == "yolo":
            factors = yolo_load_weights(det, frame[None], factors)
        t = time.perf_counter()
        got[device] = det.detect_batch(frame[None])
        got[f"{device}_s"] = time.perf_counter() - t
        det.cleanup()
    a, b = got["cuda"], got["cpu"]
    kept = np.sort(b.scores[0][b.valid[0]])[::-1]
    check(len(kept) > 41, f"13c {model}: the CPU kept {len(kept)} boxes at threshold 0")
    thr = float(kept[39] + kept[40]) / 2
    va, vb = a.valid[0] & (a.scores[0] >= thr), b.valid[0] & (b.scores[0] >= thr)
    ba, sa, bb, sb = a.boxes_xywh[0][va], a.scores[0][va], b.boxes_xywh[0][vb], b.scores[0][vb]
    check(len(ba) == len(bb) == 40, f"13c {model}: {len(ba)} detections on the card, {len(bb)} on the CPU")
    free, d_boxes, d_scores = list(range(len(ba))), 0.0, 0.0
    for i in np.argsort(-sb, kind="stable"):
        fits = [j for j in free if abs(sa[j] - sb[i]) <= SINGLE_SHOT_TOL["scores"]
                and np.abs(ba[j] - bb[i]).max() <= SINGLE_SHOT_TOL["boxes"]]
        check(bool(fits), f"13c {model}: the CPU's detection {bb[i].tolist()} ({sb[i]:.6f}) has no card "
              f"detection within {SINGLE_SHOT_TOL}")
        j = min(fits, key=lambda j: np.abs(ba[j] - bb[i]).max())
        free.remove(j)
        d_boxes, d_scores = max(d_boxes, float(np.abs(ba[j] - bb[i]).max())), max(d_scores, float(abs(sa[j] - sb[i])))
    return {"max_dboxes": d_boxes, "max_dscores": d_scores, "cpu_s": got["cpu_s"], "threshold": thr,
            "detections": len(bb)}


def ultralytics_route(frames: np.ndarray, tmp: Path) -> dict:
    """An ultralytics-layout YOLOv8x state_dict (tests/helpers/torch_yolov8.py,
    seeded weights and BN statistics) saved as ``.pt`` and loaded by the
    port's YOLODetector on the card; its raw outputs against the
    ultralytics-layout model's own forward on the card, float32, TF32 off."""
    from office_person_detection_vit_torch.detection import YOLODetector
    from office_person_detection_vit_torch.models.yolo import VARIANTS
    from office_person_detection_vit_torch.ops.preprocessing import preprocess_frames

    spec = importlib.util.spec_from_file_location("torch_yolov8", ROOT / "tests" / "helpers" / "torch_yolov8.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    tm = mod.DetectionModel(VARIANTS["x"], nc=1)
    g = torch.Generator().manual_seed(13)
    with torch.no_grad():  # the load's kernels (a fixed 0.05 overflows 100 layers deep), small biases
        for name, p in tm.named_parameters():
            if "dfl" not in name:
                std = YOLO_LOAD_GAIN / math.sqrt(p[0].numel()) if p.dim() == 4 else 0.05
                p.copy_(torch.randn(p.shape, generator=g) * std)
    mod.randomize_bn_stats(tm, 14)
    tm.eval()
    path = tmp / "best.pt"
    torch.save(tm.state_dict(), path)
    det = YOLODetector({f"detection.{k}": v for k, v in single_shot_config("yolo", dtype="float32").items()}
                       | {"detection.checkpoint_path": str(path)})
    det.load_model()
    batch = det.detect_batch(frames[:1])
    pixels, _ = preprocess_frames(torch.from_numpy(frames[:1]).cuda(), target_hw=(736, 1280))
    tm = tm.cuda()
    with torch.inference_mode():
        levels = det.model(pixels)["levels"]
        ref = tm(pixels.permute(0, 3, 1, 2).contiguous())
    err, spread = 0.0, 0.0
    for lv, (box, cls) in zip(levels, ref):
        for got, want in ((lv["box_dist"], box.permute(0, 2, 3, 1)), (lv["class_logits"], cls.permute(0, 2, 3, 1))):
            err = max(err, ((got - want).abs() / want.abs().clamp(min=1.0)).max().item())
            spread = max(spread, want.std().item())
    check(err <= 1e-3 and spread > 1e-2 and batch.boxes_xywh.shape == (1, 100, 4),
          f"13c: the ultralytics .pt route on the card: raw outputs {err:.2e} from the ultralytics-layout model "
          f"(their spread {spread:.2e})")
    det.cleanup()
    del tm, det
    torch.cuda.empty_cache()
    return {"rel_err": err, "output_spread": spread}


def single_shot_phase(ka, probe, smi: str, frames: np.ndarray, videos: Path, tmp: Path) -> dict:
    """[13c]: YOLOv8x and the single-shot detector through detect_batch at
    full width (frames/s, median of 3; no attention kernel launched), each
    float32 on the card against the CPU, the ultralytics ``.pt`` route on the
    card, and ``main`` with ``detection.model: yolo`` on the one-hour video."""
    from office_person_detection_vit_torch.detection import build_detector
    from office_person_detection_vit_torch.models.weights import save_flat_npz

    t0 = time.perf_counter()
    out = {}
    for model in ("yolo", "ssd"):
        det = build_detector({f"detection.{k}": v for k, v in single_shot_config(model).items()})
        det.load_model()
        if model == "yolo":
            yolo_load_weights(det, frames[:8])
        zero = det.detect_batch(frames[:16])  # warm-up at threshold 0
        threshold = load_threshold([s[v] for s, v in zip(zero.scores, zero.valid)])
        det.confidence_threshold = threshold
        torch.cuda.synchronize()
        ka.reset_launch_counts()
        batch = det.detect_batch(frames[:16])
        counts = dict(ka.launch_counts)
        per_frame = batch.valid.sum(1)
        check(det.last_failed_chunks == 0 and batch.boxes_xywh.shape == (16, 100, 4)
              and all(np.isfinite(a).all() for a in (batch.boxes_xywh, batch.scores, batch.foot)),
              f"13c {model}: detect failed or gave non-finite detections")
        check(counts == launches(), f"13c {model}: launched attention kernels {counts}")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            det.detect_batch(frames[:16])
            times.append(time.perf_counter() - t)
        fps = sorted(16 / t for t in times)
        params = sum(p.numel() for p in det.model.parameters())
        out[model] = {"fps_median": fps[1], "fps": fps, "threshold": threshold, "params": params,
                      "detections_per_frame": [int(per_frame.min()), float(per_frame.mean()), int(per_frame.max())]}
        log(f"[13c] {type(det).__name__} ({params / 1e6:.2f} M parameters) bf16 736x1280 batch 8: {fps[-1]:.2f} "
            f"frames/s best, {fps[1]:.2f} median, {fps[0]:.2f} worst (3 runs x 16 frames, host clock, uint8 frames in, "
            f"DetectionBatch out); detections a frame min/mean/max {out[model]['detections_per_frame']} at threshold "
            f"{threshold:.6f}; no attention kernel launched on {smi}")
        if model == "yolo":
            weights = tmp / "yolov8x_seeded.npz"
            save_flat_npz(weights, det.model.state_dict(), det.model_config)
            out[model]["weights"], out[model]["threshold"] = weights, threshold
        det.cleanup()
        del det
        torch.cuda.empty_cache()
        # a noise frame: the rendered ones' flat regions give many cells the same score to the bit
        noise = np.random.default_rng(13).integers(0, 256, frames[0].shape, np.uint8)
        out[model]["float32"] = single_shot_card_vs_cpu(model, noise)
        f32 = out[model]["float32"]
        log(f"[13c] {model} float32 at 736x1280, batch 1, on the card vs the CPU ({f32['cpu_s']:.1f} s): "
            f"{f32['detections']} detections each at threshold {f32['threshold']:.6f}, paired within max|dboxes| "
            f"{f32['max_dboxes']:.2e} px, max|dscores| {f32['max_dscores']:.2e} (bars {SINGLE_SHOT_TOL})")
        torch.cuda.empty_cache()
    out["ultralytics"] = ultralytics_route(frames, tmp)
    log(f"[13c] the ultralytics .pt route (YOLOv8x state_dict, BN folded with eps 1e-3) on the card: raw outputs "
        f"within {out['ultralytics']['rel_err']:.2e} of the ultralytics-layout model's, relative to max(1,|ref|) "
        f"(outputs spread by up to {out['ultralytics']['output_spread']:.2e})")
    n = 13
    detection = single_shot_config("yolo", checkpoint_path=str(out["yolo"].pop("weights")),
                                   confidence_threshold=out["yolo"]["threshold"])
    cfg = flow_config(videos / "hour.mp4", tmp / "yolo_out", detection, np.eye(3), hour_zones())
    rc, main_counts, secs, session = run_main(ka, probe, cfg, tmp / "yolo.yaml")
    check(rc == 0, f"13c: main with detection.model yolo exited {rc}")
    summary = check_session(session, list(HOUR_QUADS), n, "13c", stats_keys=STATISTICS_KEYS - {"transfer_format"})
    check(sum(probe.failed_chunks) == 0 and probe.chunks == 2 and main_counts == launches(),
          f"13c: main: {sum(probe.failed_chunks)} chunks raised of {probe.chunks}; launched {main_counts}")
    stats = json.loads((session / "02_detection" / "detection_statistics.json").read_text())
    out["main"] = {"detections": stats["total_detections"], "seconds": secs, "performance": summary["performance"],
                   "session": session}
    log(f"[13c] main with detection.model yolo (YOLOv8x, bf16, batch 8) on the one-hour video: {n} frames in "
        f"{probe.chunks} chunks, {stats['total_detections']} detections; phase seconds {phase_seconds(summary)}; main "
        f"{secs:.3f} s (host clock) on {smi}")
    log(f"[13c] phase {time.perf_counter() - t0:.1f} s")
    return out


def detector_slice(ka, build, probe, smi: str, frames: np.ndarray, day_frames: list, videos: Path,
                   samples: list) -> dict:
    """Phase 13: head dims up to 128, the upload routes, the single-shot
    families."""
    t = time.perf_counter()
    d128 = d128_phase(ka, build, smi, frames, samples)
    with tempfile.TemporaryDirectory() as tmp:
        routes = transfer_phase(ka, smi, day_frames, Path(tmp))
        single = single_shot_phase(ka, probe, smi, frames, videos, Path(tmp))
        routes["main"] = route_mains(ka, probe, smi, single["main"].pop("session"), videos, Path(tmp),
                                     routes.pop("weights"), routes["threshold"])
    log(f"[13] detector phase {time.perf_counter() - t:.1f} s")
    return {"d128": d128, "routes": routes, "single_shot": single}


def d128_kernel_rows(res: dict) -> list:
    """The kernels line's rows of the head-dim-128 bodies, each at the shape
    of the path its launches come from: K2 at the ViT-H-width DETR's detect,
    K1 at its float32 forward, B.4 and its backward pair at its training
    shape VITH_TRAIN beside their launches in that model's 8 steps."""
    src = "office_person_detection_vit_torch/csrc/attention.cu"
    d128 = res["d128"]
    k2 = d128["forward"][D128_KERNEL_CASES[0][:3]]
    k1 = d128["forward"][D128_KERNEL_CASES[2][:3]]
    b4 = d128["b4_path"]
    train_path = "ViT-H/16-width DETR (4 of 32 layers) bf16 training at 768x1344, batch 8, 8 steps, phase 13a"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "dtype")
    return [
        {"name": "attention_flash_d128", "route": "cuda", "source": src, "body": "attention_flash_wgmma<bf16,128>",
         "replaces": "office_person_detection_vit_tpu/ops/attention.py:159",
         "launches": d128["k2_d128"],
         "launches_on": "ViT-H/16-width DETR (4 of 32 layers) bf16 through detect_batch at 736x1280, 16 frames, "
                        "phase 13a", **{k: k2[k] for k in keys + ("instruction",)}},
        {"name": "attention_whole_kv_d128", "route": "cuda", "source": src,
         "replaces": "office_person_detection_vit_tpu/ops/attention.py:60", "launches": d128["k1_d128"],
         "launches_on": "ViT-H/16-width DETR float32 forward at 224x224 on the card, phase 13a",
         **{k: k1[k] for k in keys + ("instruction",)}},
        {"name": "attention_diff_d128", "route": "cuda", "source": src,
         "body": "attention_flash_wgmma<bf16,128> + attention_bwd_dq_wgmma<bf16,128> + "
                 "attention_bwd_dkdv_wgmma<bf16,128>",
         "function": "office_person_detection_vit_torch/ops/attention.py KernelAttention",
         "replaces": "office_person_detection_vit_tpu/ops/attention.py:306",
         "launches": d128["train_d128"]["attention_diff"], "launches_on": train_path,
         **{k: b4[k] for k in keys + ("forward_ms", "backward_ms")}},
        {"name": "attention_backward_d128", "route": "cuda", "source": src,
         "body": "attention_bwd_dq_wgmma<bf16,128> + attention_bwd_dkdv_wgmma<bf16,128>",
         "replaces": "office_person_detection_vit_tpu/ops/attention.py:322",
         "launches": d128["train_d128"]["attention_backward"], "launches_on": train_path,
         "max_abs_err": b4["max_abs_err"], "ms": b4["pair_ms"], "plain_ms": b4["plain_backward_ms"],
         "bound_ms": b4["backward_bound_ms"], "bound_by": b4["backward_bound_by"],
         "library_ms": b4["library_backward_ms"], "shape": b4["shape"], "dtype": b4["dtype"]},
    ]


# ------------------------------------------------------------------ phase 14
# C.7 closed: head dims above 128 run. bf16 K2 and B.4's pair at 192 and 256
# (136 padded to 192) run the Hopper bodies (attention_flash_wgmma_inline,
# attention_bwd_dq_wgmma_inline and attention_bwd_dkdv_wgmma at <bf16,192|256>
# in csrc/attention.cu); K1, float32 and bf16 above 256 the chunked bodies
# (attention_wide*; CUDA cores in both types, Q.K^T over 64-wide head-dim
# chunks, output columns split over 128-wide grid-z blocks). [14a] holds K1,
# K2 and B.4 at head dims 136, 192 and 256 in both types, and bf16 K2 and B.4
# at 320 (the chunked bf16 bodies), against the plain version at [2]'s bars
# and B.4 at [10a]'s gate, times them against SDPA and
# the bound, and drives them on a model's path: DETR with a ViT backbone
# whose heads are 256 wide (hidden 1024 over 4 heads, MLP 4096, 2 layers;
# VITW), which no published model has, so that a detect, a float32 forward
# and training steps launch them.
WIDE_KERNEL_CASES = [
    ("attention_flash", (8, 4, 46 * 80 + 1, 46 * 80 + 1, 256), "bfloat16", False,
     "the VITW detect's ViT at 736x1280, heads of 256 (K2, the path's shape)"),
    ("attention_flash", (8, 4, 1008, 1008, 256), "bfloat16", True, "heads of 256 at 1008 tokens (K2)"),
    ("attention_flash", (8, 4, 1008, 1008, 256), "float32", True, "heads of 256 at 1008 tokens, float32 (K2)"),
    ("attention_flash", (8, 4, 1008, 1008, 192), "bfloat16", True, "heads of 192 at 1008 tokens (K2)"),
    ("attention_flash", (8, 4, 1008, 1008, 192), "float32", True, "heads of 192 at 1008 tokens, float32 (K2)"),
    ("attention_whole_kv", (8, 4, 197, 197, 256), "float32", False, "heads of 256 at 224x224 tokens (K1)"),
    ("attention_whole_kv", (8, 4, 197, 197, 256), "bfloat16", False, "heads of 256 at 224x224, bf16 (K1)"),
    ("attention_whole_kv", (8, 4, 197, 197, 192), "float32", False, "heads of 192 at 224x224 tokens (K1)"),
    ("attention_whole_kv", (8, 4, 197, 197, 192), "bfloat16", False, "heads of 192 at 224x224, bf16 (K1)"),
    ("attention_flash", (2, 4, 300, 260, 136), "bfloat16", True, "head dim 136, padded to 192 (K2)"),
    ("attention_flash", (2, 4, 300, 260, 136), "float32", True, "head dim 136, padded to 192, float32 (K2)"),
    ("attention_whole_kv", (2, 4, 300, 260, 136), "bfloat16", True, "head dim 136, padded to 192 (K1)"),
    ("attention_whole_kv", (2, 4, 300, 260, 136), "float32", True, "head dim 136, padded to 192, float32 (K1)"),
    ("attention_flash", (8, 4, 1008, 1008, 320), "bfloat16", True, "heads of 320 at 1008 tokens (bf16 K2, chunked)"),
]
WIDE_B4_CASES = [((2, 4, 300, 260, 136), "bfloat16", True, "head dim 136, padded to 192"),
                 ((2, 4, 300, 260, 136), "float32", True, "head dim 136, padded to 192, float32"),
                 ((1, 4, 1008, 1008, 192), "bfloat16", True, "heads of 192 at 1008 tokens"),
                 ((2, 4, 197, 197, 192), "float32", False, "heads of 192 at 224x224, float32"),
                 ((1, 4, 1008, 1008, 256), "bfloat16", False, "heads of 256 at 1008 tokens"),
                 ((2, 4, 197, 197, 256), "float32", True, "heads of 256 at 224x224, float32"),
                 ((1, 4, 1008, 1008, 320), "bfloat16", True, "heads of 320 at 1008 tokens (the chunked bf16 pair)")]
VITW = dict(backbone="vit", vit_hidden=1024, vit_heads=4, vit_mlp=4096, vit_layers=2)
VITW_CALLS = 2 + 18
#: B.4 on that model's training path: 768x1344 (4033 tokens), batch 8.
VITW_TRAIN = (8, 4, 48 * 84 + 1, 48 * 84 + 1, 256)


def wide_count(ka, name: str) -> int:
    """Launches at a head dim above 128 since the last reset_head_dim_counts."""
    return sum(n for (wrapper, d), n in ka.head_dim_counts.items() if wrapper == name and d > 128)


def hmma_of_wide(counts: dict, name: str) -> int:
    """The HMMA count (ops_of) of the chunked bodies, named
    ``base<type[,K1|K2]>``: their template takes the type and, in the
    forward, whether it runs two passes (K1, ``Lb1E``) or one (K2,
    ``Lb0E``)."""
    base, args = name.rstrip(">").split("<")
    dtype, *kind = args.split(",")
    typ = "13__nv_bfloat16" if dtype == "bf16" else "f"
    passes = {"K1": "Lb1E", "K2": "Lb0E"}[kind[0]] if kind else ""
    mangled = re.compile(rf"{len(base)}{base}I{typ}{passes}E")
    found = [n["HMMA"] for f, n in counts.items() if mangled.search(f)]
    check(len(found) == 1, f"{name}: {len(found)} functions of its name in the SASS")
    return found[0]


def wide_phase(ka, build, smi: str, frames: np.ndarray, samples: list) -> dict:
    """[14a]: the chunked bodies' registers and spills (none allowed) and
    HMMA count (none: CUDA cores), and [1]'s readings of every Hopper body
    at head dims 192 and 256 (no spill); the forward cases and B.4 at
    [10a]'s gate; then the VITW DETR through detect_batch (bf16, 736x1280,
    batch 8: K2 on the Hopper body), its float32 forward at 224x224 card
    against CPU (K1), and 8 of its bf16 training steps at 768x1344 (B.4 on
    the Hopper bodies)."""
    from office_person_detection_vit_torch import attention_kernel_bench as abench
    from office_person_detection_vit_torch.detection.detector import DETRDetector
    from office_person_detection_vit_torch.models.detr import DETRConfig
    from office_person_detection_vit_torch.models.weights import flax_param_map

    t0 = time.perf_counter()
    counts = sass_counts(build)
    bodies = {}
    for a in ka.kernel_attributes():
        if a["name"].startswith("attention_wide"):
            n_hmma = hmma_of_wide(counts, a["name"])
            check(a["local_bytes"] == 0, f"14a: {a['name']} spills {a['local_bytes']} B a thread")
            check(n_hmma == 0, f"14a: {a['name']}: {n_hmma} HMMA instructions (a CUDA-core body)")
            bodies[a["name"]] = {"regs": a["regs"], "local_bytes": a["local_bytes"], "hmma": n_hmma}
            log(f"[14a] {a['name']:36s} regs {a['regs']:3d}  spill (local) {a['local_bytes']} B  HMMA in SASS {n_hmma}")
    check(len(bodies) == 8, f"14a: {len(bodies)} chunked bodies, expected 8")
    hopper = {}
    for a in ka.kernel_attributes():
        if a["name"].endswith((",192>", ",256>")):
            ops = ops_of(counts, a["name"])
            check(a["local_bytes"] == 0, f"14a: {a['name']} spills {a['local_bytes']} B a thread")
            text = check_tensor_cores(a, ops, "14a")
            hopper[a["name"]] = {"regs": a["regs"], "local_bytes": a["local_bytes"], "hmma": ops["HMMA"],
                                 "hgmma": ops["HGMMA"], "utmaldg": ops["UTMALDG"]}
            log(f"[14a] {a['name']:36s} regs {a['regs']:3d}  spill (local) {a['local_bytes']} B  {text}")
    check(len(hopper) == 6 and all("wgmma" in n for n in hopper),
          f"14a: Hopper bodies at 192 and 256 {sorted(hopper)}, expected K2 and the pair at each")
    check(ka.is_wgmma(256, torch.bfloat16) and ka.is_wgmma(136, torch.bfloat16)
          and not ka.is_wgmma(320, torch.bfloat16), "14a: is_wgmma does not name bf16 at 136-256 alone")
    rows = {}
    for seed, case in enumerate(WIDE_KERNEL_CASES):
        row = abench.measure(ka, case, 900 + seed)
        log(f"[14a] {abench.describe(row)} [{case[4]}]")
        rows[case[:3]] = row
        torch.cuda.empty_cache()
    b4 = b4_phase(ka, smi, WIDE_B4_CASES, WIDE_B4_CASES, tag="14a")
    b4_path = vit_b4_timing(ka, smi, VITW_TRAIN, "14a", 950, "VITW (heads of 256) training at 768x1344, batch 8")

    cfg = DETRConfig(dtype="bfloat16", **VITW)
    det = DETRDetector({f"detection.{k}": v for k, v in vit_detector_config().items()}, detr_config=cfg)
    det.load_model()
    det.detect_batch(frames[:8])  # warm-up
    torch.cuda.synchronize()
    ka.reset_launch_counts()
    ka.reset_head_dim_counts()
    batch = det.detect_batch(frames[:16])
    torch.cuda.synchronize()
    detect_counts, k2_wide = dict(ka.launch_counts), wide_count(ka, "attention_flash")
    check(det.last_failed_chunks == 0 and all(np.isfinite(a).all() for a in (batch.boxes_xywh, batch.scores)),
          "14a: VITW detect failed or gave non-finite detections")
    check(detect_counts == launches(flash=VITW_CALLS * 2) and k2_wide == 4,
          f"14a: VITW detect launched {detect_counts}, {k2_wide} above head dim 128 (expected {VITW_CALLS} K2 a "
          "chunk x 2, 2 a chunk at 256)")
    log(f"[14a] DETR with a ViT of 256-wide heads (VITW) bf16 736x1280 batch 8 through detect_batch: launches "
        f"{detect_counts} over 2 chunks, {k2_wide} of them K2 at head dim 256 (attention_flash_wgmma_inline<bf16,256>)")
    det.cleanup()
    del det
    torch.cuda.empty_cache()

    fcfg = DETRConfig(dtype="float32", **VITW)
    flash = 2 * ka.use_flash(197, 256, torch.float32) + 6 * (2 * ka.use_flash(196, 32, torch.float32)
                                                             + ka.use_flash(100, 32, torch.float32))
    ka.reset_head_dim_counts()
    d_logits, d_boxes, cpu_secs = float32_card_vs_cpu(ka, fcfg, frames[:1], launches(whole_kv=20 - flash, flash=flash),
                                                      "14a", hw=(224, 224))
    f32_wide = wide_count(ka, "attention_whole_kv")
    check(f32_wide == 2, f"14a: the float32 forward launched {f32_wide} K1 above head dim 128, expected 2")
    log(f"[14a] float32 VITW DETR at 224x224 on the card ({20 - flash} K1, {flash} K2; {f32_wide} K1 at head dim 256) "
        f"vs the CPU ({cpu_secs:.1f} s): max|dlogits| {d_logits:.2e} (atol {LOGITS_ATOL} rtol {LOGITS_RTOL}), "
        f"max|dboxes| {d_boxes:.2e} (atol {BOXES_ATOL})")
    torch.cuda.empty_cache()

    ka.reset_head_dim_counts()
    tcfg = DETRConfig(dtype="bfloat16", dropout=0.1, **VITW)
    train = train_full_width(ka, smi, samples, tcfg, tag="14a", calls=VITW_CALLS, leaves=len(flax_param_map(tcfg)),
                             name="VITW DETR (heads of 256)")
    train_wide = {"attention_diff": wide_count(ka, "attention_flash"),
                  "attention_backward": wide_count(ka, "attention_backward")}
    check(train_wide == {"attention_diff": 16, "attention_backward": 16},
          f"14a: 8 training steps launched {train_wide} above head dim 128, expected 2 B.4 pairs a step")
    log(f"[14a] 8 VITW training steps: {train_wide} above head dim 128, on attention_flash_wgmma_inline<bf16,256> and "
        "the pair attention_bwd_dq_wgmma_inline<bf16,256> + attention_bwd_dkdv_wgmma<bf16,256>")
    log(f"[14a] phase {time.perf_counter() - t0:.1f} s")
    return {"bodies": bodies, "hopper": hopper, "forward": rows, "b4": b4, "b4_path": b4_path,
            "detect_counts": detect_counts, "k2_wide": k2_wide, "f32_wide": f32_wide, "train_wide": train_wide,
            "train": train}


# [14b]: the single-shot trainers at full width (A.7c): the JAX trainer's
# full size, bf16 compute from float32 master weights at 768x1344, batch 8,
# lr 1e-4, over [10]'s 16 images; the float32 card step against the CPU's at
# batch 1. A step's gradients are held as [10c] holds DETR-small's (each leaf
# within SMALL_GRAD_RTOL of its max |grad|), and the update where it is
# stable: AdamW's first step moves an element by lr g / (|g| + eps), about lr
# times the sign of its gradient, so an element whose gradient is noise on
# both sides may move either way, and an error dg moves the update by at
# most lr dg / |g|. Where the CPU's gradient is at least
# SINGLE_SHOT_UPDATE_FLOOR of its leaf's max, dg / |g| is under
# SMALL_GRAD_RTOL / SINGLE_SHOT_UPDATE_FLOOR, and so is the update's error
# in units of lr.
SINGLE_SHOT_UPDATE_FLOOR = 0.1
SINGLE_SHOT_UPDATE_TOL = SMALL_GRAD_RTOL / SINGLE_SHOT_UPDATE_FLOOR


def single_shot_train_setup(model_name: str, dtype: str, device: str):
    """A seeded YOLOv8x or single-shot model (float32 master weights) on
    ``device``, its TrainState and train step (the YOLO or FCOS criterion on
    the letterboxed content), and its config."""
    from office_person_detection_vit_torch.models.single_shot import SingleShotConfig, SingleShotDetector
    from office_person_detection_vit_torch.models.yolo import YOLOConfig, YOLOv8
    from office_person_detection_vit_torch.ops.preprocessing import compute_resize_geometry
    from office_person_detection_vit_torch.training import (TrainState, make_optimizer, make_ssd_train_step,
                                                            make_yolo_train_step)

    content = compute_resize_geometry((720, 1280), TRAIN_HW)
    if model_name == "yolo":
        cfg = YOLOConfig(variant="x", dtype=dtype)
        model, make = YOLOv8(cfg), make_yolo_train_step
    else:
        cfg = SingleShotConfig(dtype=dtype)
        model, make = SingleShotDetector(cfg), make_ssd_train_step
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(device)
    tx = make_optimizer(learning_rate=1e-4, backbone_lr=1e-5)
    return cfg, model, TrainState.create(model, tx), make(model, tx, TRAIN_HW, content_hw=content)


def single_shot_steps(smi: str, samples: list, model_name: str, n: int = 8) -> dict:
    """2 warm-up and n - 2 timed bf16 steps over the loader's two batches of
    8 (two per epoch): ms a step (CUDA events), images/s, peak memory; every
    loss finite, and each batch's loss lower at its last visit than at its
    first."""
    from office_person_detection_vit_torch.training import COCOBatchLoader

    cfg, model, state, step = single_shot_train_setup(model_name, "bfloat16", "cuda")
    n_params = sum(p.numel() for p in state.params)
    loader = COCOBatchLoader(samples, TRAIN_BATCH, capacity=32, seed=0)
    batches = [{k: v for k, v in to_device(b, TRAIN_HW, torch.bfloat16).items() if k != "pixel_mask"}
               for b in loader.epoch(0)]
    generator = torch.Generator().manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for i in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batches[i % len(batches)], generator)
        end.record()
        torch.cuda.synchronize()
        losses.append(metrics["loss"].item())
        if i >= 2:
            ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(math.isfinite(x) for x in losses), f"14b {model_name}: non-finite losses {losses}")
    first, last = losses[:len(batches)], losses[-len(batches):]
    check(all(b < a for a, b in zip(first, last)), f"14b {model_name}: losses did not fall: {losses}")
    med = statistics.median(ms)
    name = {"yolo": "YOLOv8x", "ssd": "the single-shot detector (ResNet-50 + FPN)"}[model_name]
    log(f"[14b] {name} ({n_params / 1e6:.2f} M parameters, seeded) bf16 (float32 master weights) 768x1344 batch "
        f"{TRAIN_BATCH}, lr 1e-4, {len(samples)} images: {n - 2} timed steps after 2 warm-up, median {med:.3f} ms a "
        f"step (CUDA events; {min(ms):.3f}-{max(ms):.3f}), {TRAIN_BATCH * 1e3 / med:.2f} images/s, peak memory "
        f"{peak:.2f} GiB; losses {', '.join(f'{x:.4f}' for x in losses)} on {smi}")
    del state, model, step, batches
    torch.cuda.empty_cache()
    return {"params_m": n_params / 1e6, "step_ms": med, "step_ms_min": min(ms), "step_ms_max": max(ms),
            "images_per_s": TRAIN_BATCH * 1e3 / med, "peak_gib": peak, "losses": losses}


def train_step_card_vs_cpu(smi: str, samples: list, model_name: str) -> dict:
    """One float32 step at batch 1, 768x1344, on the card (TF32 off) and on
    the CPU from the same weights and batch: the losses within 1e-4
    relative, every gradient within SMALL_GRAD_RTOL of its leaf's max, the
    stable updates within SINGLE_SHOT_UPDATE_TOL of lr."""
    from office_person_detection_vit_torch.device import full_float32
    from office_person_detection_vit_torch.training import COCOBatchLoader

    host_batch = next(iter(COCOBatchLoader(samples[:1], 1, capacity=32, seed=0).epoch(0)))
    runs = {}
    for where in ("cuda", "cpu"):
        cfg, model, state, step = single_shot_train_setup(model_name, "float32", where)
        before = [p.detach().clone() for p in state.params]
        b = {k: v.to(where) for k, v in to_device(host_batch, TRAIN_HW, torch.float32).items() if k != "pixel_mask"}
        t = time.perf_counter()
        with full_float32():
            state, metrics = step(state, b, torch.Generator().manual_seed(1))
        secs = time.perf_counter() - t
        runs[where] = {"metrics": {k: v.item() for k, v in metrics.items()}, "secs": secs,
                       "grads": [p.grad.detach().cpu() if p.grad is not None else torch.zeros_like(p).cpu()
                                 for p in state.params],
                       "updates": [(p.detach() - a).cpu() for p, a in zip(state.params, before)], "keys": state.keys}
        del model, state, step
    card, cpu = runs["cuda"], runs["cpu"]
    loss_err = max(abs(card["metrics"][k] - v) / max(abs(v), 1e-12) for k, v in cpu["metrics"].items())
    grad_worst, update_worst, stable = 0.0, 0.0, 0
    for a, b, ua, ub in zip(card["grads"], cpu["grads"], card["updates"], cpu["updates"]):
        top = max(b.abs().max().item(), 1e-30)
        grad_worst = max(grad_worst, (a - b).abs().max().item() / top)
        sel = b.abs() >= SINGLE_SHOT_UPDATE_FLOOR * top
        stable += int(sel.sum())
        if sel.any():
            update_worst = max(update_worst, (ua - ub)[sel].abs().max().item() / 1e-4)
    n = sum(g.numel() for g in cpu["grads"])
    check(loss_err <= 1e-4 and grad_worst <= SMALL_GRAD_RTOL and update_worst <= SINGLE_SHOT_UPDATE_TOL,
          f"14b {model_name} float32 card vs CPU: losses {loss_err:.2e} (bar 1e-4), gradients {grad_worst:.2e} of "
          f"the leaf's max (bar {SMALL_GRAD_RTOL:.0e}), stable updates {update_worst:.2e} of lr "
          f"(bar {SINGLE_SHOT_UPDATE_TOL:.0e})")
    log(f"[14b] {model_name} one float32 step at batch 1, 768x1344, card vs CPU ({cpu['secs']:.1f} s): losses within "
        f"{loss_err:.2e} relative (bar 1e-4), worst gradient {grad_worst:.2e} of its leaf's max |grad| (bar "
        f"{SMALL_GRAD_RTOL:.0e}), updates of the {stable} of {n} elements whose gradient is at least "
        f"{SINGLE_SHOT_UPDATE_FLOOR:.0%} of the leaf's max within {update_worst:.2e} of lr (bar "
        f"{SINGLE_SHOT_UPDATE_TOL:.0e}); card losses {card['metrics']} on {smi}")
    torch.cuda.empty_cache()
    return {"loss_err": loss_err, "grad_rel": grad_worst, "update_rel_lr": update_worst, "cpu_s": cpu["secs"]}


def yolo_fine_tune(smi: str, data: Path, tmp: Path, frame: np.ndarray) -> dict:
    """``main --fine-tune`` with ``training.model: yolo`` and
    ``training.yolo_variant: x`` at full size for one epoch (the trainer's
    ``--model yolo``), then its weights.npz in the YOLO detector on the card."""
    import logging

    import yaml

    from office_person_detection_vit_torch.detection.yolo_detector import YOLODetector
    from office_person_detection_vit_torch.main import main as port_main

    out = tmp / "yolo_fine_tune"
    cfg = {"detection": {"device": "cuda"}, "output": {"directory": str(tmp / "yolo_logs")},
           "training": {"images_dir": str(data / "train" / "images"), "annotations": str(data / "train" / "coco.json"),
                        "epochs": 1, "batch_size": TRAIN_BATCH, "output_dir": str(out), "model": "yolo",
                        "yolo_variant": "x", "input_height": TRAIN_HW[0], "input_width": TRAIN_HW[1],
                        "learning_rate": 1e-4, "augment": True}}
    path = tmp / "yolo_fine_tune.yaml"
    path.write_text(yaml.safe_dump(cfg))
    t = time.perf_counter()
    with path.with_suffix(".log").open("w") as console, contextlib.redirect_stdout(console):
        rc = port_main(["--config", str(path), "--fine-tune"])
        root = logging.getLogger()
        for handler in list(root.handlers):
            root.removeHandler(handler)
            handler.close()
    secs = time.perf_counter() - t
    if rc != 0:
        log("\n".join(path.with_suffix(".log").read_text().splitlines()[-60:]))
    check(rc == 0, f"14b: main --fine-tune with training.model yolo exited {rc}")
    history = json.loads((out / "history.json").read_text())
    steps = TRAIN_IMAGES // TRAIN_BATCH
    check(len(history["step_losses"]) == steps and all(math.isfinite(x) for x in history["step_losses"]),
          f"14b: history {history['step_losses']}")
    det = YOLODetector({"detection.model_size": "full", "detection.yolo_variant": "x", "detection.dtype": "bfloat16",
                        "detection.device": "cuda", "detection.checkpoint_path": str(out / "weights.npz"),
                        "detection.batch_size": 1, "detection.input_height": 736, "detection.input_width": 1280,
                        "detection.confidence_threshold": 0.0})
    det.load_model()
    batch = det.detect_batch(frame[None])
    check(det.last_failed_chunks == 0 and np.isfinite(batch.boxes_xywh).all() and int(batch.valid.sum()) > 0,
          "14b: the fine-tuned YOLOv8x weights do not detect")
    log(f"[14b] main --fine-tune, training.model yolo, yolo_variant x (full size, augment, 1 epoch, {steps} steps): "
        f"exit 0 in {secs:.3f} s; history.json losses {[round(x, 4) for x in history['step_losses']]}; weights.npz "
        f"({(out / 'weights.npz').stat().st_size} bytes) in the YOLO detector on the card: {int(batch.valid.sum())} "
        f"boxes on one frame at confidence 0 on {smi}")
    det.cleanup()
    return {"secs": secs, "losses": history["step_losses"]}


def single_shot_train_phase(smi: str, samples: list, data: Path, frame: np.ndarray) -> dict:
    """[14b]: YOLOv8x and the single-shot detector trained at full width,
    each float32 step on the card against the CPU's, and ``main --fine-tune``
    with ``training.model: yolo``."""
    t = time.perf_counter()
    out = {m: single_shot_steps(smi, samples, m, 8 if m == "yolo" else 6) for m in ("yolo", "ssd")}
    for m in ("yolo", "ssd"):
        out[m]["float32"] = train_step_card_vs_cpu(smi, samples, m)
    with tempfile.TemporaryDirectory() as tmp:
        out["fine_tune"] = yolo_fine_tune(smi, data, Path(tmp), frame)
    log(f"[14b] phase {time.perf_counter() - t:.1f} s")
    return out


# [14c]: export and serve (A.8). DETR-R50 bf16 at 736x1280 (720p frames),
# seeded weights with [11c]'s person head (every query's top class is person,
# so every query is a detection at confidence 0), exported with a symbolic
# batch; served by `python -m office_person_detection_vit_torch.serve
# --artifact ... --weights ...` in a fresh process. The served detections of
# 8 concurrent JPEG posts are held against detect_batch of the decoded frames
# by the same weights: scores within SERVE_SCORE_TOL and boxes within
# SERVE_BOX_TOL px (bf16: the micro-batcher's batches are not detect_batch's,
# and cuDNN may pick other algorithms at another batch size; a bf16 score
# near 1 is 2^-8 apart from its neighbours, a coordinate of 1280 px 5 px).
SERVE_SCORE_TOL, SERVE_BOX_TOL = 2.0**-5, 8.0


def export_serve_phase(ka, smi: str, frames: np.ndarray, tmp: Path) -> dict:
    import socket
    import urllib.request

    import cv2

    from office_person_detection_vit_torch.detection import export as port_export
    from office_person_detection_vit_torch.detection.detector import DETRDetector

    t0 = time.perf_counter()
    det = DETRDetector({"detection.model_size": "full", "detection.dtype": "bfloat16", "detection.device": "cuda",
                        "detection.batch_size": 8, "detection.input_height": 736, "detection.input_width": 1280,
                        "detection.confidence_threshold": 0.0})
    det.load_model()
    person_head(det)
    t = time.perf_counter()
    program = port_export.export_detect(det)
    export_s = time.perf_counter() - t
    artifact, weights = tmp / "detr_r50_bf16.pt2", tmp / "detr_r50_bf16_weights.npz"
    size = port_export.save_exported(program, artifact)
    leaves = port_export.save_weights_npz(det, weights)
    ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    n_op = sum(o == "office_person_detection_vit_torch.attention.default" for o in ops)
    check(n_op == 18 and not any("scaled_dot_product" in o for o in ops),
          f"14c: the exported graph holds {n_op} calls of the attention operator (expected 18) and "
          f"{sum('scaled_dot_product' in o for o in ops)} SDPA")
    log(f"[14c] exported DETR-R50 bf16 (symbolic batch, 720x1280 frames) in {export_s:.1f} s: {size} bytes, "
        f"{len(ops)} graph calls, {n_op} of them torch.ops.office_person_detection_vit_torch.attention, no SDPA; "
        f"weights {leaves} leaves, path-keyed")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = subprocess.Popen([sys.executable, "-m", "office_person_detection_vit_torch.serve", "--artifact",
                               str(artifact), "--weights", str(weights), "--confidence", "0.0", "--host", "127.0.0.1",
                               "--port", str(port)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        lines, t = [], time.perf_counter()
        while time.perf_counter() - t < 300:
            line = server.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving on"):
                break
        check(lines and lines[-1].startswith("serving on"), f"14c: the server did not start: {''.join(lines)[-3000:]}")
        start_s = time.perf_counter() - t

        def get(path):
            with urllib.request.urlopen(f"{url}{path}", timeout=60) as r:
                return json.loads(r.read())

        warm = get("/stats")
        jpegs = [cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes() for f in frames[:8]]
        docs, latency = [None] * len(jpegs), [None] * len(jpegs)

        def post(i):
            t = time.perf_counter()
            req = urllib.request.Request(f"{url}/detect", data=jpegs[i], method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                docs[i] = json.loads(r.read())
            latency[i] = (time.perf_counter() - t) * 1e3

        import threading

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(jpegs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        stats = get("/stats")
    finally:
        server.terminate()
        try:
            server.wait(timeout=30)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
    check(all(d is not None for d in docs), "14c: a request got no answer")
    served = stats["requests"] - warm["requests"]
    batches = stats["batches"] - warm["batches"]
    k2 = stats["attention_launches"]["attention_flash"] - warm["attention_launches"]["attention_flash"]
    check(served == 8 and batches < 8, f"14c: {served} requests in {batches} batches (expected 8, coalesced)")
    warm_k2 = warm["attention_launches"]["attention_flash"]
    check(k2 == 18 * batches and warm_k2 == 18 * 4 and stats["attention_launches"]["attention_whole_kv"] == 0,
          f"14c: the server launched {k2} K2 for {batches} batches (expected 18 a batch), {warm_k2} warming its "
          f"4 buckets (expected 72) and {stats['attention_launches']['attention_whole_kv']} K1")
    decoded = np.stack([cv2.imdecode(np.frombuffer(j, np.uint8), cv2.IMREAD_COLOR) for j in jpegs])
    want = det.detect_batch(decoded).to_frame_results()
    score_err = box_err = 0.0
    for doc, fr in zip(docs, want):
        check(len(doc["detections"]) == len(fr.detections),
              f"14c: {len(doc['detections'])} served detections against {len(fr.detections)} of detect_batch")
        for g, w in zip(doc["detections"], fr.detections):
            score_err = max(score_err, abs(g["confidence"] - w.confidence))
            b = g["bbox"]
            box_err = max(box_err, max(abs(x - y) for x, y in zip((b["x"], b["y"], b["width"], b["height"]), w.bbox)))
    check(score_err <= SERVE_SCORE_TOL and box_err <= SERVE_BOX_TOL,
          f"14c: served detections off detect_batch's by {score_err:.3e} in score (bar {SERVE_SCORE_TOL:.3e}) and "
          f"{box_err:.3f} px (bar {SERVE_BOX_TOL})")
    lat = sorted(latency)
    log(f"[14c] serve --artifact in a fresh process: up in {start_s:.1f} s (artifact load, weights, the buckets "
        f"1, 2, 4 and 8 warmed: {warm_k2} K2 launches); 8 concurrent JPEG posts answered in {batches} device batches, K2 launched "
        f"{k2} times (18 a batch; the served program ran the hand-written kernel); latency ms min/median/max "
        f"{lat[0]:.1f}/{lat[len(lat) // 2]:.1f}/{lat[-1]:.1f} (host clock, client side); detections against "
        f"detect_batch of the decoded frames: {sum(len(d['detections']) for d in docs)} boxes, scores within "
        f"{score_err:.3e}, boxes within {box_err:.3f} px on {smi}")
    det.cleanup()
    del det, program
    torch.cuda.empty_cache()
    log(f"[14c] phase {time.perf_counter() - t0:.1f} s")
    return {"artifact_bytes": size, "export_s": export_s, "server_start_s": start_s, "batches": batches,
            "k2_launches": k2, "latency_ms": lat, "score_err": score_err, "box_err": box_err}


def scale_out_phase(smi: str, tmp: Path) -> dict:
    """[14d]: ``torchrun --nproc_per_node 1`` on NCCL runs the scale-out
    self-check (``parallel/selfcheck.py``): the sharded DETR and YOLO steps
    against the one-process step (loss to 1e-5 relative, parameters and EMA
    to 1e-5 of max(1, |leaf|)), sharded detection against one forward, an
    all-reduce over the group; and a grid of 2 model ranks over 1 raises."""
    import socket

    from office_person_detection_vit_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1", "--master_addr",
                           "127.0.0.1", "--master_port", str(port), "-m",
                           "office_person_detection_vit_torch.parallel.selfcheck", "dp", str(tmp), "cuda"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"14d: torchrun exited {proc.returncode}: {(proc.stdout + proc.stderr)[-3000:]}")
    res = json.loads((tmp / "rank0.json").read_text())
    check(res["backend"] == "nccl" and res["all_reduce"] == 1.0, f"14d: {res.get('backend')} {res.get('all_reduce')}")
    for model in ("detr", "yolo"):
        got = res[model]
        check(got["metrics"] and got["moved"] and max(got["loss"], got["params"], got["ema"]) <= 1e-5,
              f"14d: the sharded {model} step against the one-process step: {got}")
    check(res["detect"]["valid"] == 0 and res["detect"]["scores"] <= 1e-5 and res["detect"]["boxes_xywh"] <= 1e-3,
          f"14d: sharded detection {res['detect']}")
    try:
        make_mesh(model_parallel=2)
        raised = False
    except ValueError as e:
        raised = "must divide" in str(e)
    check(raised, "14d: make_mesh(model_parallel=2) on one process did not raise")
    log(f"[14d] torchrun --nproc_per_node 1 (NCCL, grid {res['shape']}): the sharded DETR step (dropout, augment, "
        f"EMA) against the one-process step: loss {res['detr']['loss']:.2e}, parameters {res['detr']['params']:.2e}, "
        f"EMA {res['detr']['ema']:.2e}; YOLO loss {res['yolo']['loss']:.2e}, parameters {res['yolo']['params']:.2e}; "
        f"sharded detect {res['detect']}; make_mesh(model_parallel=2) over 1 rank raises; "
        f"{time.perf_counter() - t0:.1f} s on {smi}")
    return res


def scale_slice(ka, build, smi: str, frames: np.ndarray, samples: list, data: Path) -> dict:
    """Phase 14: head dims above 128, the single-shot trainers, export and
    serving, scale-out on one card."""
    t = time.perf_counter()
    wide = wide_phase(ka, build, smi, frames, samples)
    trainers = single_shot_train_phase(smi, samples, data, frames[0])
    with tempfile.TemporaryDirectory() as tmp:
        serving = export_serve_phase(ka, smi, frames, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        scale = scale_out_phase(smi, Path(tmp))
    log(f"[14] phase {time.perf_counter() - t:.1f} s")
    return {"wide": wide, "trainers": trainers, "serving": serving, "scale_out": scale}


def wide_kernel_rows(res: dict) -> list:
    """The kernels line's rows above head dim 128, each at the shape of the
    path its launches come from, as d128_kernel_rows: K2 (the Hopper body) at
    the VITW detect's ViT shape, K1 (chunked) at its float32 forward's, B.4
    and its pair (the Hopper bodies) at VITW_TRAIN."""
    src = "office_person_detection_vit_torch/csrc/attention.cu"
    wide = res["wide"]
    k2 = wide["forward"][WIDE_KERNEL_CASES[0][:3]]
    k1 = wide["forward"][WIDE_KERNEL_CASES[5][:3]]
    b4 = wide["b4_path"]
    train_path = "VITW DETR (ViT heads of 256) bf16 training at 768x1344, batch 8, 8 steps, phase 14a"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "dtype")
    return [
        {"name": "attention_flash_wide", "route": "cuda", "source": src, "body": "attention_flash_wgmma_inline<bf16,256>",
         "replaces": "office_person_detection_vit_tpu/ops/attention.py:159", "launches": wide["k2_wide"],
         "launches_on": "VITW DETR bf16 through detect_batch at 736x1280, 16 frames, phase 14a",
         **{k: k2[k] for k in keys + ("instruction",)}},
        {"name": "attention_whole_kv_wide", "route": "cuda", "source": src, "body": "attention_wide<float,K1>",
         "replaces": "office_person_detection_vit_tpu/ops/attention.py:60", "launches": wide["f32_wide"],
         "launches_on": "VITW DETR float32 forward at 224x224 on the card, phase 14a",
         **{k: k1[k] for k in keys + ("instruction",)}},
        {"name": "attention_diff_wide", "route": "cuda", "source": src,
         "body": "attention_flash_wgmma_inline<bf16,256> + attention_bwd_dq_wgmma_inline<bf16,256> + "
                 "attention_bwd_dkdv_wgmma<bf16,256>",
         "function": "office_person_detection_vit_torch/ops/attention.py KernelAttention",
         "replaces": "office_person_detection_vit_tpu/ops/attention.py:306",
         "launches": wide["train_wide"]["attention_diff"], "launches_on": train_path,
         **{k: b4[k] for k in keys + ("forward_ms", "backward_ms")}},
        {"name": "attention_backward_wide", "route": "cuda", "source": src,
         "body": "attention_bwd_dq_wgmma_inline<bf16,256> + attention_bwd_dkdv_wgmma<bf16,256>",
         "replaces": "office_person_detection_vit_tpu/ops/attention.py:322",
         "launches": wide["train_wide"]["attention_backward"], "launches_on": train_path,
         "max_abs_err": b4["max_abs_err"], "ms": b4["pair_ms"], "plain_ms": b4["plain_backward_ms"],
         "bound_ms": b4["backward_bound_ms"], "bound_by": b4["backward_bound_by"],
         "library_ms": b4["library_backward_ms"], "shape": b4["shape"], "dtype": b4["dtype"]},
    ]


def scale_phase_alone() -> int:
    """``--phase 14``: the build and phase 14 with its own training images
    (a child process)."""
    from office_person_detection_vit_torch import train_detr
    from office_person_detection_vit_torch.kernels import attention as ka
    from office_person_detection_vit_torch.kernels import build

    smi = card_line()
    log(f"[1] card: {smi}")
    with tempfile.TemporaryDirectory() as data:
        writer = start_dataset_writer(Path(data))
        try:
            ka.load_library()
            render_frame = load_render_frame()
            t0 = datetime(2025, 1, 20, 9, 0, 0)
            frames = np.stack([render_frame(t0 + timedelta(minutes=5 * i),
                                            people=[(300 + 20 * i, 300, 0), (800 - 15 * i, 360, 1)], seed=i)
                               for i in range(16)])
            samples = wait_dataset(writer, Path(data))
            res = scale_slice(ka, build, smi, frames, samples, Path(data))
        finally:
            if writer.poll() is None:
                writer.kill()
                writer.wait()
    print(json.dumps({"kernels": wide_kernel_rows(res)}, default=str), flush=True)
    print(json.dumps({k: res[k] for k in ("trainers", "serving", "scale_out")}, default=str), flush=True)
    return 0


def detector_phase_alone() -> int:
    """``--phase 13``: the build and phase 13 with its own one-hour video and
    training images (child processes) and [8a]'s 288 frames."""
    from office_person_detection_vit_torch import train_detr
    from office_person_detection_vit_torch.kernels import attention as ka
    from office_person_detection_vit_torch.kernels import build

    smi = card_line()
    log(f"[1] card: {smi}")
    with tempfile.TemporaryDirectory() as videos, tempfile.TemporaryDirectory() as data:
        code = f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; chip_smoke.write_hour_video({videos!r})"
        children = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), start_dataset_writer(Path(data))]
        try:
            ka.load_library()
            render_frame = load_render_frame()
            t0 = datetime(2025, 1, 20, 9, 0, 0)
            frames = np.stack([render_frame(t0 + timedelta(minutes=5 * i),
                                            people=[(300 + 20 * i, 300, 0), (800 - 15 * i, 360, 1)], seed=i)
                               for i in range(16)])
            day_frames, _ = slice_frames(render_frame, t0)
            for child in children:
                out, _ = child.communicate(timeout=600)
                check(child.returncode == 0, f"13: a writer exited {child.returncode}: {out[-2000:]}")
            samples = train_detr.load_coco_dataset(Path(data) / "train" / "images", Path(data) / "train" / "coco.json")
            res = detector_slice(ka, build, FlowProbe(), smi, frames, day_frames, Path(videos), samples)
        finally:
            for child in children:
                if child.poll() is None:
                    child.kill()
                    child.wait()
    print(json.dumps({"kernels": d128_kernel_rows(res)}, default=str), flush=True)
    print(json.dumps({"routes": res["routes"], "single_shot": res["single_shot"]}, default=str), flush=True)
    return 0


def write_hour_video(out_dir: str) -> None:
    """Phase 12's one-hour video alone (``--phase 12``), in a child process."""
    spec = importlib.util.spec_from_file_location("synthetic_video", ROOT / "tests" / "helpers" / "synthetic_video.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.write_video(Path(out_dir) / "hour.mp4", num_frames=video_frames(1), start_time=HOUR_START,
                    people_fn=hour_people)


# ------------------------------------------------------------------ phase 15
# The last modules. [15a]: the CLIP image tower of Re-ID's model_type clip at
# openai/clip-vit-base-patch32's published widths (hidden 768, 12 layers of
# 12 heads of 64, MLP 3072, patch 32 at 224: 50 tokens, projection 512) with
# seeded random weights (the repo holds no CLIP checkpoint), written as a HF
# directory and loaded through ReIDFeatureExtractor: 12 K1 launches a call
# (float32, 50 keys fit K1's block) whatever the number of crops.
CLIP_CROPS, CLIP_CPU_CROPS, CLIP_CALLS = 64, 16, 12
CLIP_K1 = ("attention_whole_kv", (CLIP_CROPS, 12, 50, 50, 64), "float32", False,
           "CLIP ViT-B/32 image tower, 64 crops a call (Re-ID model_type clip)")
# float32 with TF32 off on both sides; the card sums in another order (cuBLAS,
# cuDNN, K1) through 12 blocks: each component of the unit feature vectors.
CLIP_CARD_ATOL = 1e-4
# [15c]: the attention maps of the DETR-small checkpoint (means of float32
# softmax probabilities near 1/84), card against CPU.
ATTENTION_MAP_ATOL = 1e-5
# [15d]: RANSAC at a calibration tool's load, and the Re-ID diagnostics on
# [11a]'s features.
RANSAC_POINTS, RANSAC_HYPOTHESES, VIS_FEATURES = 2000, 512, 3000


def write_clip_checkpoint(path: Path, seed: int = 15) -> None:
    """A HF CLIPModel directory (config.json, model.safetensors) holding the
    vision tower and visual_projection at ViT-B/32's widths, seeded."""
    import dataclasses

    from safetensors.torch import save_file

    from office_person_detection_vit_torch.models.clip import CLIPImageTower, CLIPVisionConfig

    c = CLIPVisionConfig()
    tower = CLIPImageTower(c)
    tower.init_weights(torch.Generator().manual_seed(seed))
    path.mkdir(parents=True, exist_ok=True)
    vision = {k: v for k, v in dataclasses.asdict(c).items() if k != "projection_dim"}
    (path / "config.json").write_text(json.dumps({"model_type": "clip", "projection_dim": c.projection_dim,
                                                  "vision_config": vision}))
    save_file({k.replace("position_embedding.embedding", "position_embedding.weight"): v.contiguous()
               for k, v in tower.state_dict().items()}, str(path / "model.safetensors"))


def clip_boxes(n: int, seed: int = 15) -> list:
    rng = np.random.default_rng(seed)
    wh = rng.uniform([40, 100], [120, 300], (n, 2))
    xy = rng.uniform([0, 0], [1280, 720], (n, 2)) - wh / 2
    return [tuple(float(v) for v in (*p, *s)) for p, s in zip(xy, wh)]


def clip_phase(ka, smi: str, frame: np.ndarray, ckpt: Path) -> dict:
    """[15a]: the tower loaded through ReIDFeatureExtractor on the card and
    on the CPU; its features card against CPU; K1 at its shape against the
    plain version, SDPA and the bound; launches and crops/s."""
    from office_person_detection_vit_torch import attention_kernel_bench as abench
    from office_person_detection_vit_torch.tracking.reid_feature_extractor import ReIDFeatureExtractor

    check(not ka.use_flash(50, 64, torch.float32), "15a: use_flash sends CLIP's 50 float32 keys to K2")
    card = ReIDFeatureExtractor(model_type="clip", model_path=str(ckpt), device="cuda")
    card.load_model()
    check(card.backend == "clip" and card.feature_dim == 512, f"15a: backend {card.backend}, {card.feature_dim}-d")
    boxes = clip_boxes(CLIP_CROPS)
    card.extract_features(frame, boxes)  # warm-up
    torch.cuda.synchronize()
    ka.reset_launch_counts()
    feats = card.extract_features(frame, boxes)
    counts = dict(ka.launch_counts)
    check(counts == launches(whole_kv=CLIP_CALLS), f"15a: a CLIP call launched {counts}, expected {CLIP_CALLS} K1")
    check(feats.shape == (CLIP_CROPS, 512) and np.isfinite(feats).all()
          and np.allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-5), f"15a: features {feats.shape}")
    cpu = ReIDFeatureExtractor(model_type="clip", model_path=str(ckpt), device="cpu")
    cpu.load_model()
    t = time.perf_counter()
    want = cpu.extract_features(frame, boxes[:CLIP_CPU_CROPS])
    cpu_secs = time.perf_counter() - t
    err = float(np.abs(feats[:CLIP_CPU_CROPS] - want).max())
    check(err <= CLIP_CARD_ATOL, f"15a: card features {err:.2e} from the CPU's (bar {CLIP_CARD_ATOL})")
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        card.extract_features(frame, boxes)
        times.append(time.perf_counter() - t)
    pixels = torch.randn(CLIP_CROPS, 3, 224, 224, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    with torch.inference_mode():
        tower_ms = abench.cuda_ms(lambda: card._clip(pixels), 10)
    row = abench.measure(ka, CLIP_K1, 1500)
    check(row["max_abs_err"] <= row["tolerance"], f"15a: {abench.describe(row)}")
    rate = CLIP_CROPS / statistics.median(times)
    log(f"[15a] CLIP ViT-B/32 image tower (seeded weights, HF safetensors through ReIDFeatureExtractor, float32, "
        f"TF32 off): {CLIP_CROPS} crops a call, launches {counts}; card against CPU on {CLIP_CPU_CROPS} crops: "
        f"max|dfeature| {err:.2e} (bar {CLIP_CARD_ATOL}; CPU {cpu_secs:.2f} s); {rate:.1f} crops/s median of 10 "
        f"calls (host clock: crops and cv2.resize on the host, one upload, the tower, L2 norm), the tower alone "
        f"{tower_ms:.3f} ms a call of {CLIP_CROPS} (CUDA events) on {smi}")
    log(f"[15a] {abench.describe(row)} [{CLIP_K1[4]}]")
    return {"counts": counts, "row": row, "crops_per_s": rate, "tower_ms": tower_ms, "err": err}


def clip_tracking_phase(ka, smi: str, frames: list, stamps: list, ckpt: Path) -> dict:
    """[15b]: [8a]'s frames into TrackingPhase with tracking.reid.enabled
    and model_type clip on the card: the drawn person's box a frame, the
    cascade, then the scan on the card; the scan's ids equal to the port's
    CPU scan on the same features; each phase's seconds."""
    import copy

    from office_person_detection_vit_torch.core.dto import Detection, FrameResult
    from office_person_detection_vit_torch.pipeline.phases import TrackingPhase
    from office_person_detection_vit_torch.tracking.scan_tracker import assign_track_ids

    def load() -> list:
        return [FrameResult(i, ts, [Detection(bbox=(float(80 + 37 * i % 1100), float(120 + 53 * i % 400 - 26), 50.0,
                                                    156.0), confidence=0.9)])
                for i, ts in enumerate(stamps)]

    cfg = {"detection.device": "cuda", "tracking.enabled": True, "tracking.reid.enabled": True,
           "tracking.reid.model_type": "clip", "tracking.reid.model_path": str(ckpt)}
    secs, runs, counts = {}, {}, {}
    for engine in ("cascade", "scan"):
        results = load()
        phase = TrackingPhase({**cfg, "tracking.engine": engine})
        phase.initialize()
        check(phase.reid.backend == "clip", f"15b: {engine}: Re-ID backend {phase.reid.backend}")
        torch.cuda.synchronize()
        ka.reset_launch_counts()
        t = time.perf_counter()
        phase.execute(results, frames)
        torch.cuda.synchronize()
        secs[engine] = time.perf_counter() - t
        counts[engine] = dict(ka.launch_counts)
        check(counts[engine] == launches(whole_kv=CLIP_CALLS * len(frames)),
              f"15b: {engine} launched {counts[engine]}, expected {CLIP_CALLS} K1 a frame")
        check(all(d.feature is not None and d.feature.shape == (512,) for r in results for d in r.detections),
              f"15b: {engine}: a detection without its CLIP feature")
        check(phase.statistics["unique_tracks"] > 0, f"15b: {engine}: no track ({phase.statistics})")
        runs[engine] = (results, phase.statistics)
    scan = runs["scan"][0]
    cpu_runs = copy.deepcopy(scan)
    t = time.perf_counter()
    assign_track_ids(cpu_runs, device="cpu")
    secs["scan ids on the CPU (same features)"] = time.perf_counter() - t
    check([[d.track_id for d in r.detections] for r in scan] == [[d.track_id for d in r.detections] for r in cpu_runs],
          "15b: the scan's ids on the card differ from the port's scan on the CPU over the CLIP features")
    log(f"[15b] {len(frames)} frames of [8a] (the drawn person's box a frame) into TrackingPhase with "
        f"tracking.reid model_type clip on the card: launches {counts['scan']} a run ({CLIP_CALLS} K1 a frame); "
        f"cascade {runs['cascade'][1]}; scan {runs['scan'][1]}, its ids equal to the port's CPU scan on the same "
        f"features; seconds (host clock, card synchronised): " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
        + f" on {smi}")
    return {"counts": counts["scan"], "secs": secs}


def outputs_phase(ka, probe, smi: str, videos: Path, tmp: Path, hour_session: Path | None) -> Path:
    """[15c]: main with output.save_attention_maps and
    save_side_by_side_video (side_by_side_zoom, the detection images to
    pair) and the DETR-small checkpoint on the card, resumed after Phase 1
    of [9b]'s one-hour session (from the start when there is none): an
    overlay a frame, the card's attention maps against the CPU's, the mp4
    read back."""
    import cv2

    from office_person_detection_vit_torch.detection.detector import DETRDetector

    detection = {"model_size": "small", "score_mode": "sigmoid", "dtype": "float32", "input_height": 224,
                 "input_width": 384, "confidence_threshold": 0.2, "nms_threshold": 0.3, "batch_size": 1,
                 "checkpoint_path": str(ROOT / "docs" / "artifacts" / "detr_small_weights.npz"), "device": "cuda"}
    cfg = flow_config(videos / "hour.mp4", tmp / "outputs", detection, np.eye(3), hour_zones())
    cfg["output"].update(save_attention_maps=True, save_side_by_side_video=True, side_by_side_zoom=True,
                         save_detection_images=True, side_by_side_video_fps=2.0)
    flags = ()
    if hour_session is not None:
        session = resumable_copy(hour_session, tmp / "outputs" / hour_session.name)
        flags = ("--resume", str(session))
    rc, counts, secs, session = run_main(ka, probe, cfg, tmp / "outputs.yaml", *flags)
    check(rc == 0, f"15c: main exited {rc}")
    n = 13
    summary = check_session(session, list(HOUR_QUADS), n, "15c")
    overlays = sorted((session / "02_detection").glob("attention_*.jpg"))
    check(len(overlays) == n, f"15c: {len(overlays)} attention overlays for {n} frames")
    # 9 K1 a frame for detection and 8 for its map (the last cross-attention
    # runs the plain version, which forms the probabilities)
    check(counts == launches(whole_kv=17 * n), f"15c: main launched {counts}, expected {17 * n} K1 (9 + 8 a frame)")
    cap = cv2.VideoCapture(str(session / "06_visualization" / "side_by_side.mp4"))
    frames_read, shape = 0, None
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames_read, shape = frames_read + 1, img.shape
    cap.release()
    check(frames_read == n and shape is not None and shape[0] == 720 and shape[1] > 1280,
          f"15c: side_by_side.mp4 read back as {frames_read} frames of {shape}")
    images = [cv2.imread(str(p)) for p in sorted((session / "01_extraction" / "frames").glob("*"))]
    maps = {}
    for device in ("cuda", "cpu"):
        det = DETRDetector({f"detection.{k}": v for k, v in {**detection, "device": device}.items()})
        det.load_model()
        maps[device] = np.stack([det.get_attention_map(f) for f in images])
    err = float(np.abs(maps["cuda"] - maps["cpu"]).max())
    check(len(images) == n and err <= ATTENTION_MAP_ATOL,
          f"15c: attention maps card against CPU {err:.2e} (bar {ATTENTION_MAP_ATOL}) over {len(images)} frames")
    how = "resumed after [9b]'s Phase 1" if hour_session else "from the video"
    log(f"[15c] main with save_attention_maps, save_side_by_side_video and side_by_side_zoom, DETR-small checkpoint "
        f"float32 on the card, {how}: "
        f"{len(overlays)} attention_*.jpg for {n} frames, launches {counts} (9 K1 a frame to detect, 8 to map); "
        f"side_by_side.mp4 read back: {frames_read} frames of {shape[1]}x{shape[0]}; attention maps ({maps['cpu'].shape[1]}x"
        f"{maps['cpu'].shape[2]}) card against CPU max {err:.2e} (bar {ATTENTION_MAP_ATOL}); phase seconds "
        f"{phase_seconds(summary)}; main {secs:.3f} s on {smi}")
    return session


def ransac_load(n: int, seed: int = 15) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """n camera/floor correspondences under LOAD_H, 0.5 px of noise, 30% of
    them outliers 30-200 px off."""
    rng = np.random.default_rng(seed)
    src = rng.uniform([0, 0], [1280, 720], (n, 2))
    q = np.c_[src, np.ones(n)] @ LOAD_H.T
    dst = q[:, :2] / q[:, 2:] + rng.normal(0, 0.5, (n, 2))
    out = rng.random(n) < 0.3
    angle, size = rng.uniform(0, 2 * np.pi, n), rng.uniform(30, 200, n)
    dst[out] += (np.c_[np.cos(angle), np.sin(angle)] * size[:, None])[out]
    return src.astype(np.float32), dst.astype(np.float32), ~out


def remaining_phase(smi: str, sessions: dict, mot: dict | None, tmp: Path) -> dict:
    """[15d]: RANSAC card against CPU; FeatureVisualizer on [11a]'s
    features; the tracking-benchmark CLI; SessionDataLoader."""
    from office_person_detection_vit_torch import benchmark as bench
    from office_person_detection_vit_torch.ops.homography_fit import fit_homography_ransac
    from office_person_detection_vit_torch.tracking.scan_tracker import assign_track_ids
    from office_person_detection_vit_torch.visualization import FeatureVisualizer, SessionDataLoader
    from office_person_detection_vit_torch.visualization.feature_visualizer import silhouette

    out = {}
    src, dst, truth = ransac_load(RANSAC_POINTS)
    fit_homography_ransac(src, dst, iterations=RANSAC_HYPOTHESES, device="cuda")  # warm-up
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        h, inliers, errors = fit_homography_ransac(src, dst, iterations=RANSAC_HYPOTHESES, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    t = time.perf_counter()
    ch, cinliers, _ = fit_homography_ransac(src, dst, iterations=RANSAC_HYPOTHESES, device="cpu")
    cpu_secs = time.perf_counter() - t
    same = bool(torch.equal(inliers.cpu(), cinliers))
    check(same and bool((inliers.cpu().numpy() == truth).all()),
          f"15d: RANSAC inliers card {int(inliers.sum())}, CPU {int(cinliers.sum())}, true {int(truth.sum())}")
    out["ransac_ms"] = 1000 * statistics.median(times)
    log(f"[15d] RANSAC, {RANSAC_POINTS} correspondences (30% outliers), {RANSAC_HYPOTHESES} hypotheses in one batched "
        f"SVD: the card's inlier mask equal to the CPU's and to the truth ({int(truth.sum())}); "
        f"{out['ransac_ms']:.2f} ms median of 5 on the card, {1000 * cpu_secs:.1f} ms on the CPU (host clock); "
        f"max|dH| card-CPU {float((h.cpu() - ch).abs().max()):.2e} on {smi}")

    who: list = []
    _, results = workday_load(frames=VIS_FEATURES // (WORKDAY_PEOPLE - 2) + 2, who=who)
    feats = np.stack([d.feature for fr in results for d in fr.detections])
    ids = np.concatenate(who)
    keep = np.flatnonzero(ids >= 0)[:VIS_FEATURES]
    feats, ids = feats[keep], ids[keep]
    card = FeatureVisualizer(0, device="cuda")
    t = time.perf_counter()
    sil = card.quality_report(feats, ids)
    torch.cuda.synchronize()
    quality_secs = time.perf_counter() - t
    t = time.perf_counter()
    cpu_sil = silhouette(torch.from_numpy(feats).double(), torch.from_numpy(ids))
    cpu_secs = time.perf_counter() - t
    check(abs(sil["silhouette_by_track"] - cpu_sil) <= 1e-9, f"15d: silhouette card {sil} against CPU {cpu_sil}")
    labels, _ = card.cluster(feats, WORKDAY_PEOPLE)
    pairs = {(int(a), int(b)) for a, b in zip(labels, ids)}
    check(len(pairs) == WORKDAY_PEOPLE, f"15d: KMeans against the true ids: {len(pairs)} (label, id) pairs "
                                        f"for {WORKDAY_PEOPLE} people")
    torch.cuda.synchronize()
    t = time.perf_counter()
    emb = card.project_tsne(feats)
    torch.cuda.synchronize()
    tsne_secs = time.perf_counter() - t
    emb_sil = silhouette(torch.from_numpy(emb).double(), torch.from_numpy(ids))
    check(np.isfinite(emb).all() and emb_sil > 0.5, f"15d: t-SNE silhouette by true id {emb_sil:.4f}")
    out.update(tsne_secs=tsne_secs, silhouette=sil)
    log(f"[15d] FeatureVisualizer on {len(feats)} of [11a]'s 256-d features of {WORKDAY_PEOPLE} people: silhouette by "
        f"true id card {sil['silhouette_by_track']:.9f} (CPU {cpu_sil:.9f}), by KMeans "
        f"{sil['silhouette_by_kmeans']:.6f}; KMeans (k-means++, 10 inits) labels equal to the true ids up to a "
        f"permutation; quality report (silhouette, KMeans) {quality_secs:.2f} s on the card, the silhouette "
        f"{cpu_secs:.2f} s on the CPU; exact t-SNE "
        f"(1,000 iterations) {tsne_secs:.2f} s on the card, silhouette by true id of the embedding {emb_sil:.4f} "
        f"(host clock) on {smi}")

    if mot is None:  # --phase 15 alone: [11a]'s load through the scan on the card
        gt, results = workday_load(frames=200)
        ids_matrix = assign_track_ids(results, device="cuda")
        mot = {"gt_format": "mot", "what": "[11a]'s generator, 200 frames, scan on the card",
               "gt": "".join(f"{f},{p},{x:.2f},{y:.2f},{w:.2f},{h:.2f},1,-1,-1,-1\n"
                             for f, rows in gt.items() for p, (x, y, w, h) in rows),
               "pred": "".join(f"{f},{t},{x:.2f},{y:.2f},{w:.2f},{h:.2f},0.9,-1,-1,-1\n"
                               for f, rows in hypothesis(results, ids_matrix).items() for t, (x, y, w, h) in rows)}
    gt_path = tmp / ("gt.json" if mot["gt_format"] == "gold" else "gt.csv")
    gt_path.write_text(mot["gt"])
    (tmp / "tracks_mot.csv").write_text(mot["pred"])
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = bench.main(["--gt", str(gt_path), "--pred", str(tmp / "tracks_mot.csv"), "--gt-format", mot["gt_format"],
                         "--json", "--report", str(tmp / "report")])
    doc = json.loads(printed.getvalue())
    direct = scores(bench.load_gold_gt(gt_path) if mot["gt_format"] == "gold" else bench.load_mot_csv(gt_path),
                    bench.load_mot_csv(tmp / "tracks_mot.csv"))
    check(rc == 0 and (tmp / "report" / "tracking_report.md").exists() and doc["mota"] == direct["mota"]
          and doc["idf1"] == direct["idf1"] and doc["hota"]["hota"] == direct["hota"],
          f"15d: the benchmark CLI printed {doc}, the metrics give {direct}")
    out["benchmark"] = {k: doc[k] for k in ("mota", "idf1")} | {"hota": doc["hota"]["hota"]}
    log(f"[15d] python -m office_person_detection_vit_torch.benchmark on {mot['what']}: MOTA {doc['mota']:.4f}, "
        f"IDF1 {doc['idf1']:.4f}, HOTA {doc['hota']['hota']:.4f} (equal to mot_metrics called directly); the json, "
        f"md and diagnostics reports written")

    for name, session in sessions.items():
        loader = SessionDataLoader(session, device="cuda")
        status = loader.phase_status()
        zones, rows = loader.zone_counts()
        summary = loader.summary() or {}
        check(status and all(v in ("completed", "skipped") for v in status.values()) and rows
              and len(loader.extraction_results()) == summary.get("statistics", {}).get("frames_extracted"),
              f"15d: SessionDataLoader over {name}: {status}, {len(rows)} zone rows")
        log(f"[15d] SessionDataLoader over {name}: phases {status}; {len(loader.extraction_results())} extracted "
            f"frames, {len(rows)} zone_counts rows over {zones}, {len(loader.images('06_visualization'))} images in "
            f"06_visualization, {len(loader.floor_trajectories())} floor trajectories")
    return out


def last_modules_slice(ka, probe, smi: str, frames: list, stamps: list, videos: Path, sessions: dict,
                       hour_session: Path | None, mot: dict | None) -> dict:
    """Phase 15: the last modules on the card."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = tmp / "clip-vit-base-patch32-seeded"
        write_clip_checkpoint(ckpt)
        clip = clip_phase(ka, smi, frames[0], ckpt)
        clip["tracking"] = clip_tracking_phase(ka, smi, frames, stamps, ckpt)
        session = outputs_phase(ka, probe, smi, videos, tmp, hour_session)
        rest = remaining_phase(smi, {**sessions, "[15c]'s session": session}, mot, tmp)
    log(f"[15] last-modules phase {time.perf_counter() - t:.1f} s")
    return {"clip": clip, "rest": rest}


def clip_kernel_rows(res: dict) -> list:
    """The kernels line's row of K1 on the CLIP path: its launches in one
    ReIDFeatureExtractor call of [15a] and in [15b]'s scan run."""
    row = res["clip"]["row"]
    return [{"name": "attention_whole_kv_clip", "route": "cuda",
             "source": "office_person_detection_vit_torch/csrc/attention.cu",
             "replaces": "office_person_detection_vit_tpu/ops/attention.py:60",
             "launches": res["clip"]["counts"]["attention_whole_kv"],
             "launches_on": f"ReIDFeatureExtractor(model_type='clip').extract_features, {CLIP_CROPS} crops, "
                            "CLIP ViT-B/32 float32, phase 15a",
             "launches_other_paths": {"phase 15b TrackingPhase scan with CLIP Re-ID over 288 frames":
                                          res["clip"]["tracking"]["counts"]["attention_whole_kv"]},
             **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
                                    "dtype", "instruction")}}]


def last_modules_alone() -> int:
    """``--phase 15``: the build and phase 15 with its own one-hour video (a
    child process) and [8a]'s frames; [15c] runs main from the video."""
    from office_person_detection_vit_torch.kernels import attention as ka

    smi = card_line()
    log(f"[1] card: {smi}")
    with tempfile.TemporaryDirectory() as videos:
        code = f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; chip_smoke.write_hour_video({videos!r})"
        child = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)
        try:
            ka.load_library()
            frames, stamps = slice_frames(load_render_frame(), datetime(2025, 1, 20, 9, 0, 0))
            out, _ = child.communicate(timeout=600)
            check(child.returncode == 0, f"15: the video writer exited {child.returncode}: {out[-2000:]}")
            res = last_modules_slice(ka, FlowProbe(), smi, frames, stamps, Path(videos), {}, None, None)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    print(json.dumps({"kernels": clip_kernel_rows(res)}, default=str), flush=True)
    return 0


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port.")
    parser.add_argument("--phase", choices=["10a", "11", "12", "13", "14", "15"], help="run only this phase (after the build) and "
                        "print its rows")
    parser.add_argument("--showcase-session", type=Path, default=None,
                        help="[11b]: resume this directory's session/ (a showcase session made elsewhere, its "
                        "scenario.json beside it) after Phase 1, instead of making the video here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card only", file=sys.stderr)
        return 1
    if args.phase == "10a":
        from office_person_detection_vit_torch.kernels import attention as ka

        smi = card_line()
        log(f"[1] card: {smi}")
        ka.load_library()
        rows = b4_phase(ka, smi)
        print(json.dumps({"b4": list(rows.values())}), flush=True)
        return 0
    if args.phase == "11":
        from office_person_detection_vit_torch.kernels import attention as ka

        smi = card_line()
        log(f"[1] card: {smi}")
        ka.load_library()
        frames, stamps = slice_frames(load_render_frame(), datetime(2025, 1, 20, 9, 0, 0))
        got = tracking_slice(ka, FlowProbe(), smi, frames, stamps, args.showcase_session)
        print(json.dumps({"tracking": {"workday": got["workday"], "showcase_k1": got["showcase"]["counts"],
                                       "load_k2": got["load"]}}, default=str), flush=True)
        return 0
    if args.phase == "12":
        return vit_phase_alone()
    if args.phase == "13":
        return detector_phase_alone()
    if args.phase == "14":
        return scale_phase_alone()
    if args.phase == "15":
        return last_modules_alone()
    with tempfile.TemporaryDirectory() as videos, tempfile.TemporaryDirectory() as data:
        writer = start_video_writer(Path(videos))  # phase 9's videos, written while phases 1-8 run
        dataset_writer = start_dataset_writer(Path(data))  # phase 10's images
        try:
            return run(writer, Path(videos), dataset_writer, Path(data), args.showcase_session)
        finally:
            for child in (writer, dataset_writer):
                if child.poll() is None:
                    child.kill()
                    child.wait()


def vit_phase_alone() -> int:
    """``--phase 12``: the build, [1]'s kernel table, and phase 12 with its
    own one-hour video and training images, written by child processes."""
    from office_person_detection_vit_torch.kernels import attention as ka
    from office_person_detection_vit_torch.kernels import build

    smi = card_line()
    log(f"[1] card: {smi}")
    with tempfile.TemporaryDirectory() as videos, tempfile.TemporaryDirectory() as data:
        code = f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; chip_smoke.write_hour_video({videos!r})"
        children = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), start_dataset_writer(Path(data))]
        try:
            ka.load_library()
            render_frame = load_render_frame()
            t0 = datetime(2025, 1, 20, 9, 0, 0)
            frames = np.stack([render_frame(t0 + timedelta(minutes=5 * i),
                                            people=[(300 + 20 * i, 300, 0), (800 - 15 * i, 360, 1)], seed=i)
                               for i in range(16)])
            for child in children:
                out, _ = child.communicate(timeout=600)
                check(child.returncode == 0, f"12: a writer exited {child.returncode}: {out[-2000:]}")
            vit = vit_slice(ka, build, FlowProbe(), smi, frames, Path(videos), Path(data))
        finally:
            for child in children:
                if child.poll() is None:
                    child.kill()
                    child.wait()
    print(json.dumps({"kernels": vit_kernel_rows(vit)}, default=str), flush=True)
    return 0


def run(writer: subprocess.Popen, videos: Path, dataset_writer: subprocess.Popen, data: Path,
        showcase_session: Path | None = None) -> int:
    from office_person_detection_vit_torch import attention_kernel_bench as abench
    from office_person_detection_vit_torch.detection.detector import DETRDetector
    from office_person_detection_vit_torch.kernels import attention as ka
    from office_person_detection_vit_torch.kernels import bottleneck as kb
    from office_person_detection_vit_torch.kernels import build
    from office_person_detection_vit_torch.models.detr import DETRConfig
    from office_person_detection_vit_torch.ops.aggregation import zone_count_matrix
    from office_person_detection_vit_torch.ops.geometry import homography_transform, validate_homography
    from office_person_detection_vit_torch.ops.zones import ZoneClassifier

    # ---- 1. device and build
    smi = card_line()
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
    check(det.last_failed_chunks == 0, f"full-width detect: {det.last_failed_chunks} of {chunks} chunks raised")
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

    d_logits, d_boxes, _ = float32_card_vs_cpu(ka, DETRConfig(dtype="float32"), frames[:2], launches(whole_kv=6, flash=12),
                                               "3")
    log(f"[3] float32 DETR-R50 on the card (K1 x6, K2 x12) vs CPU (plain): max|dlogits| "
        f"{d_logits:.2e} (atol {LOGITS_ATOL} rtol {LOGITS_RTOL}), max|dboxes| {d_boxes:.2e} (atol {BOXES_ATOL})")

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
    check(small_counts == launches(whole_kv=9),
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

    # ---- 8. the slice: phases 2-4 through the port's phases, on the card
    slice_counts, day_frames, day_stamps = full_width_phase(ka, smi, render_frame, t_start, H, zones)
    load_phase("cuda", smi, t_start)
    trained_counts = trained_phase(ka, smi, render_frame, t_start)

    # ---- 9. the whole flow through the port's entry point, on the card
    day_counts, hour_counts, probe = flow_phase(ka, smi, writer, videos, H, zones)

    # ---- 10. the training slice on the card
    train = training_phase(ka, smi, dataset_writer, data, frames[0])

    # ---- 11. the tracking slice on the card
    tracking = tracking_slice(ka, probe, smi, day_frames, day_stamps, showcase_session)

    # ---- 12. the ViT slice on the card
    vit = vit_slice(ka, build, probe, smi, frames[:16], videos, data)

    # ---- 13. head dims up to 128, the upload routes, YOLOv8 and the single-shot detector
    from office_person_detection_vit_torch.train_detr import load_coco_dataset

    samples = load_coco_dataset(data / "train" / "images", data / "train" / "coco.json")
    detectors = detector_slice(ka, build, probe, smi, frames[:16], day_frames, videos, samples)

    # ---- 14. head dims above 128, the single-shot trainers, export and serving, scale-out
    scale = scale_slice(ka, build, smi, frames[:16], samples, data)

    # ---- 15. the last modules: CLIP Re-ID, the new outputs, RANSAC, the diagnostics, the benchmark CLI
    last = last_modules_slice(ka, probe, smi, day_frames, day_stamps, videos,
                              {"[9a]'s session": kept_session(videos, "day")}, kept_session(videos, "hour"),
                              tracking["showcase"]["mot"])

    # ---- result
    replaces = {"attention_whole_kv": "office_person_detection_vit_tpu/ops/attention.py:60",
                "attention_flash": "office_person_detection_vit_tpu/ops/attention.py:159"}
    # Each attention kernel's row at the encoder shape of the path that
    # launches it, beside that path's own count: K2 runs the bf16 main path
    # (use_flash sends every bf16 call to it), K1 the float32 DETR-small;
    # the port's entry point (9a, 9b) drives both paths.
    headline = {
        "attention_whole_kv": (("attention_whole_kv", (1, 8, 84, 84, 16), "float32"), hour_counts,
                               "DETR-small float32 through main on the card, 13 frames, phase 9b"),
        "attention_flash": (("attention_flash", (8, 8, 920, 920, 32), "bfloat16"), day_counts,
                            f"DETR-R50 bf16 through main over a {DAY_HOURS}-hour video, {DAY_HOURS * 12 + 1} frames, "
                            "transfer_format auto (its race included), phase 9a (the main path)"),
    }
    other_paths = {"attention_whole_kv": {"phase 5 DETR-small detect": small_counts["attention_whole_kv"],
                                          "phase 8b DETR-small through phases 2-4": trained_counts["attention_whole_kv"],
                                          "phase 10c DETR-small training step (two forwards)":
                                              train["small"]["attention_whole_kv"],
                                          "phase 11b the DETR-small showcase through main into tracking":
                                              tracking["showcase"]["counts"]["attention_whole_kv"]},
                   "attention_flash": {"phase 3 DETR-R50 detect": main_counts["attention_flash"],
                                       "phase 8a DETR-R50 through phases 2-4": slice_counts["attention_flash"],
                                       "phase 10b DETR-R50 training, 6 timed steps": train["full"]["counts"]["attention_flash"],
                                       "phase 10d main --fine-tune, 2 steps": train["handoff"]["attention_flash"],
                                       "phase 11c DETR-R50 through phases 2-4 with tracking":
                                           tracking["load"]["attention_flash"]}}
    kernels = [
        {"name": name, "route": "cuda", "source": "office_person_detection_vit_torch/csrc/attention.cu",
         "replaces": replaces[name], "launches": counts[name], "launches_on": path,
         "launches_other_paths": other_paths[name],
         **{k: rows[key][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                      "shape", "dtype", "instruction")}}
        for name, (key, counts, path) in headline.items()
    ] + [k3_row]
    # B.4: K1/K2 forward with the log-sum-exp, the backward kernel pair; its
    # row at the full-width encoder shape of training, its launches
    # (forwards) on phase 10b's path. The pair has a row of its own beside
    # it: its launches on the same path, its time alone, the plain version of
    # the pair and SDPA's backward alone.
    enc = train["b4"][B4_CASES[0][0]]
    train_path = "DETR-R50 bf16 training at 768x1344, batch 8, 6 timed steps, phase 10b"
    kernels.append({
        "name": "attention_diff", "route": "cuda",
        "source": "office_person_detection_vit_torch/csrc/attention.cu",
        "function": "office_person_detection_vit_torch/ops/attention.py KernelAttention",
        "replaces": "office_person_detection_vit_tpu/ops/attention.py:306",
        "launches": train["full"]["counts"]["attention_diff"], "launches_on": train_path,
        "launches_other_paths": {"phase 10c DETR-small training step (card)": train["small"]["attention_whole_kv"],
                                 "phase 10d main --fine-tune, 2 steps": train["handoff"]["attention_diff"]},
        **{k: enc[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                               "forward_ms", "backward_ms", "backward_bound_ms", "backward_bound_by",
                               "shape", "dtype")},
        "backward_library_ms": enc["library_backward_ms"],
        "instruction": "mma.sync.m16n8k16 (bf16: the K2 forward and the backward pair); FFMA (float32)",
    })
    kernels.append({
        "name": "attention_backward", "route": "cuda", "source": "office_person_detection_vit_torch/csrc/attention.cu",
        "replaces": "office_person_detection_vit_tpu/ops/attention.py:322",
        "launches": train["full"]["counts"]["attention_backward"], "launches_on": train_path,
        "launches_other_paths": {"phase 10c DETR-small training step (card)": train["small"]["attention_backward"],
                                 "phase 10d main --fine-tune, 2 steps": train["handoff"]["attention_backward"]},
        "max_abs_err": enc["grad_err_vs_float64_rel"], "ms": enc["pair_ms"], "plain_ms": enc["plain_backward_ms"],
        "bound_ms": enc["backward_bound_ms"], "bound_by": enc["backward_bound_by"],
        "library_ms": enc["library_backward_ms"], "shape": enc["shape"], "dtype": enc["dtype"],
        "instruction": "mma.sync.m16n8k16 (bf16); FFMA (float32)",
    })
    kernels += vit_kernel_rows(vit)
    kernels += d128_kernel_rows(detectors)
    kernels += wide_kernel_rows(scale)
    kernels += clip_kernel_rows(last)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
