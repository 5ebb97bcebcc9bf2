"""Where the time of one full-width detect goes, on the card.

    python -m office_person_detection_vit_torch.profile_detect

Runs ``DETRDetector`` (DETR-R50, bf16, 736x1280, batch 8, seeded random
weights) on synthetic 720p frames: one warm-up chunk, then two chunks under
``torch.profiler``. Prints the card, the host-clock frames/s of the profiled
window, the device busy share (summed kernel time over the window's wall
time; the port runs on one stream, so kernels do not overlap), the kernel
time by category and the top kernels. Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .detection.detector import DETRDetector

BATCH, CHUNKS, TOP = 8, 2, 20
CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("attention (K1/K2)", ("attention_whole_kv", "attention_flash")),
    ("convolution", ("conv", "implicit_gemm", "xmma_fprop", "cudnn", "nchwtonhwc", "nhwctonchw")),
    ("matmul", ("gemm", "cutlass", "nvjet", "cublas")),
    ("layer norm", ("layer_norm",)),
    ("host-to-device upload", ("memcpy htod",)),
    ("copy / layout", ("copy", "cat", "transpose", "memcpy", "memset")),
    ("bool logic (NMS loop, masks)", ("binaryfunctor<bool",)),
    ("elementwise mul/add (FrozenBN, residual)", ("mulfunctor", "functor_add", "binaryfunctor")),
    ("ReLU (clamp)", ("clamp",)),
)


def _category(name: str) -> str:
    low = name.lower()
    for label, keys in CATEGORIES:
        if any(k in low for k in keys):
            return label
    return "other elementwise / reduction"


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_detect needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    det = DETRDetector({
        "detection.model_size": "full", "detection.dtype": "bfloat16", "detection.device": "cuda",
        "detection.batch_size": BATCH, "detection.input_height": 736,
        "detection.input_width": 1280, "detection.nms_threshold": 0.4,
    })
    rng = np.random.default_rng(0)
    frames = np.full((BATCH * CHUNKS, 720, 1280, 3), 40, np.uint8)
    frames += rng.integers(0, 12, frames.shape, dtype=np.uint8)
    det.detect_batch(frames[:BATCH])  # warm-up: build, load, cuDNN choice
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det.detect_batch(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time_total > 0:
            by_kernel[ev.name] += ev.device_time_total / 1e3  # us -> ms
            counts[ev.name] += 1
    busy = sum(by_kernel.values())
    by_cat: dict[str, float] = defaultdict(float)
    for name, ms in by_kernel.items():
        by_cat[_category(name)] += ms
    n = len(frames)
    print(f"card: {card}")
    print(f"window: {n} frames in {CHUNKS} chunks of {BATCH}; wall {wall * 1e3:.2f} ms "
          f"({n / wall:.2f} frames/s, host clock); device busy {busy:.2f} ms = {100 * busy / (wall * 1e3):.1f}% "
          f"(idle {100 - 100 * busy / (wall * 1e3):.1f}%)")
    for label, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {label:44s} {ms:9.3f} ms  {100 * ms / busy:5.1f}% of device time")
    print("top kernels:")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"  {ms:9.3f} ms  x{counts[name]:<5d} {name[:150]}")


if __name__ == "__main__":
    main()
