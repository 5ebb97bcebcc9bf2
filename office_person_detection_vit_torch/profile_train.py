"""Where the time of a full-size DETR or YOLOv8x training step goes, on the card.

    python -m office_person_detection_vit_torch.profile_train \\
        [--model detr|yolo] [--backbone resnet50|vit] [--against DIR] [--json-out PATH]

Trains DETR-R50 at the JAX trainer's full size (bf16 compute from float32
master weights, 768x1344, batch 8, dropout 0.1, aux loss; seeded random
weights) on one seeded batch made on the card: 8 random 720p frames through
``preprocess_frames`` and two targets an image. No loader and no
augmentation, so the step alone is timed. After 2 warm-up steps it runs
ROUNDS rounds of STEPS steps, each step timed with CUDA events at its marks
(forward, matcher, loss, backward, optimizer) and on the host clock, then
profiles 2 steps under ``torch.profiler``: the device's busy share of the
window (summed kernel time over the window's wall time; the port runs on one
stream) and of an unprofiled step (the same kernel time over the median
step), and its kernel time by category, B.4's forward (K1/K2) and its
backward pair apart. ``--model yolo`` trains YOLOv8x the same way (bf16 from
float32 master weights, 768x1344, batch 8, the YOLO criterion on the
letterboxed content; no pixel mask, no matcher mark). ``--backbone vit``
trains DETR with ViT-base/16 as its backbone (``detection.backbone: vit``;
12 B.4 pairs at head dim 64 a step on 4033 tokens, and 18 in the encoder
and decoder at 32), as ``profile_detect --backbone vit`` profiles its detect.

``--against DIR`` trains the port checkout at ``DIR`` (an earlier commit
unpacked with ``git archive``) beside this one in one process, on the same
batch, each with its own model from the same seed, the rounds alternating
this, other, other, this, ... so both are timed by one method on one card.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from .attention_kernel_bench import load_port_module
from .bottleneck_kernel_bench import card

HW, BATCH, TARGETS, WARMUP, PROFILED = (768, 1344), 8, 2, 2, 2
STEPS, ROUNDS = 6, 4  # timed steps a round; rounds, alternating with --against
MARKS = ("forward", "matcher", "loss", "backward", "optimizer")
YOLO_MARKS = ("forward", "loss", "backward", "optimizer")
CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("B.4 backward pair", ("attention_bwd",)),
    ("B.4 forward (K1/K2)", ("attention_whole_kv", "attention_flash")),
    ("convolution", ("conv", "implicit_gemm", "xmma_fprop", "xmma_dgrad", "xmma_wgrad", "cudnn",
                     "nchwtonhwc", "nhwctonchw")),
    ("matmul", ("gemm", "cutlass", "nvjet", "cublas")),
    ("softmax", ("softmax",)),
    ("layer norm", ("layer_norm",)),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("reduction", ("reduce",)),
    ("copy / layout", ("copy", "cat", "transpose", "memcpy", "memset")),
)


def _category(name: str) -> str:
    low = name.lower()
    for label, keys in CATEGORIES:
        if any(k in low for k in keys):
            return label
    return "other elementwise"


def make_batch(seed: int = 0) -> dict:
    """Eight seeded 720p uint8 frames preprocessed on the card (letterboxed
    into 768x1344, bf16) and two person boxes an image in 32 target slots."""
    from .ops.preprocessing import preprocess_frames

    g = torch.Generator().manual_seed(seed)
    frames = torch.randint(0, 256, (BATCH, 720, 1280, 3), generator=g, dtype=torch.uint8)
    pixels, mask = preprocess_frames(frames.cuda(), target_hw=HW, out_dtype=torch.bfloat16)
    labels = torch.zeros(BATCH, 32, dtype=torch.int32)
    labels[:, :TARGETS] = 1
    boxes = torch.zeros(BATCH, 32, 4)
    boxes[:, :TARGETS, :2] = 0.2 + 0.6 * torch.rand(BATCH, TARGETS, 2, generator=g)
    boxes[:, :TARGETS, 2:] = 0.1 + 0.2 * torch.rand(BATCH, TARGETS, 2, generator=g)
    valid = torch.zeros(BATCH, 32, dtype=torch.bool)
    valid[:, :TARGETS] = True
    return {"pixels": pixels, "pixel_mask": mask, "labels": labels.cuda(), "boxes": boxes.cuda(),
            "valid": valid.cuda()}


class Trainer:
    """One port checkout's model, optimizer state and train step."""

    def __init__(self, root: Path | None, label: str, model_name: str = "detr", backbone: str = "resnet50"):
        def module(name):
            return importlib.import_module(f"{__package__}.{name}") if root is None else load_port_module(root, name)

        training = module("training")
        self.label = label
        self.marks = MARKS
        if model_name == "yolo":
            yolo, pre = module("models.yolo"), module("ops.preprocessing")
            model = yolo.YOLOv8(yolo.YOLOConfig(variant="x"))
            self.marks = YOLO_MARKS
        else:
            detr = module("models.detr")
            model = detr.DETR(detr.DETRConfig(dtype="bfloat16", dropout=0.1, backbone=backbone))
        model.init_weights(torch.Generator().manual_seed(0))
        model.cuda()
        tx = training.make_optimizer(learning_rate=1e-4, backbone_lr=1e-5)
        self.state = training.TrainState.create(model, tx)
        if model_name == "yolo":
            self.step_fn = training.make_yolo_train_step(
                model, tx, HW, content_hw=pre.compute_resize_geometry((720, 1280), HW))
        else:
            self.step_fn = training.make_train_step(model, tx)
        self.generator = torch.Generator().manual_seed(1)
        self.steps: list[dict] = []

    def step(self, batch: dict) -> dict:
        """One step: device ms of each part (CUDA events at the marks), of
        the whole step, and host ms."""
        events = {n: torch.cuda.Event(enable_timing=True) for n in ("start", *self.marks)}
        torch.cuda.synchronize()
        t = time.perf_counter()
        events["start"].record()
        self.state, metrics = self.step_fn(self.state, batch, self.generator, mark=lambda n: events[n].record())
        torch.cuda.synchronize()
        host = (time.perf_counter() - t) * 1e3
        if not all(torch.isfinite(v).all() for v in metrics.values()):
            raise RuntimeError(f"{self.label}: non-finite loss {metrics}")
        parts, prev = {}, "start"
        for n in self.marks:
            parts[n] = events[prev].elapsed_time(events[n])
            prev = n
        return {"step_ms": events["start"].elapsed_time(events["optimizer"]), "host_ms": host, **parts}

    def profile(self, batch: dict) -> dict:
        """PROFILED steps under torch.profiler: wall, busy share, kernels a
        step and device ms by category and by kernel."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(PROFILED):
                self.state, _ = self.step_fn(self.state, batch, self.generator)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        by_kernel: dict[str, float] = defaultdict(float)
        launches = 0
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.device_time_total > 0:
                by_kernel[ev.name] += ev.device_time_total / 1e3
                launches += 1
        busy = sum(by_kernel.values())
        by_cat: dict[str, float] = defaultdict(float)
        for name, ms in by_kernel.items():
            by_cat[_category(name)] += ms / PROFILED
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
        return {"wall_ms_per_step": wall / PROFILED, "busy_ms_per_step": busy / PROFILED,
                "busy_share": busy / wall, "kernels_per_step": launches / PROFILED,
                "by_category_ms_per_step": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
                "top_kernels_ms_per_step": {name[:120]: ms / PROFILED for name, ms in top}}


def summary(steps: list[dict]) -> dict:
    return {k: statistics.median(s[k] for s in steps) for k in steps[0]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=("detr", "yolo"), default="detr")
    p.add_argument("--backbone", choices=("resnet50", "vit"), default="resnet50",
                   help="DETR's backbone (detection.backbone); --model yolo takes none")
    p.add_argument("--against", type=Path, help="a port checkout trained beside this one")
    p.add_argument("--json-out", type=Path)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train times training steps on the card and needs one")
    if args.model == "yolo" and args.backbone != "resnet50":
        raise SystemExit("--backbone is DETR's; YOLOv8x has its own")

    smi = card()
    print(f"device: {smi}", flush=True)
    batch = make_batch()
    if args.model == "yolo":
        del batch["pixel_mask"]
    trainers = [Trainer(None, "this", args.model, args.backbone)] + (
        [Trainer(args.against, "other", args.model, args.backbone)] if args.against else [])
    for tr in trainers:
        for _ in range(WARMUP):
            tr.step(batch)
    order = []  # this, other, other, this, ...
    for r in range(ROUNDS):
        order += trainers if r % 2 == 0 else trainers[::-1]
    for tr in order:
        tr.steps += [tr.step(batch) for _ in range(STEPS)]
    results = {"device": smi, "model": args.model, "backbone": args.backbone,
               "against": str(args.against) if args.against else None,
               "steps_per_round": STEPS, "rounds": ROUNDS, "order": [tr.label for tr in order]}
    for tr in trainers:
        med = summary(tr.steps)
        prof = tr.profile(batch)
        prof["busy_share_of_unprofiled_step"] = prof["busy_ms_per_step"] / med["step_ms"]
        results[tr.label] = {"median": med, "steps": tr.steps, "profile": prof}
        print(f"[{tr.label}] {len(tr.steps)} steps, median step {med['step_ms']:.3f} ms on the card (CUDA events; "
              f"steps {min(s['step_ms'] for s in tr.steps):.3f}-{max(s['step_ms'] for s in tr.steps):.3f}), host "
              f"{med['host_ms']:.3f} ms; " + ", ".join(f"{n} {med[n]:.3f}" for n in tr.marks), flush=True)
        print(f"[{tr.label}] profiled {PROFILED} steps: wall {prof['wall_ms_per_step']:.3f} ms a step, device busy "
              f"{prof['busy_ms_per_step']:.3f} ms ({100 * prof['busy_share']:.1f}% of the profiled window, "
              f"{100 * prof['busy_share_of_unprofiled_step']:.1f}% of the median unprofiled step), "
              f"{prof['kernels_per_step']:.0f} kernels a step", flush=True)
        for label, ms in prof["by_category_ms_per_step"].items():
            print(f"  {label:24s} {ms:9.3f} ms a step  {100 * ms / prof['busy_ms_per_step']:5.1f}% of device time")
    if args.json_out:
        args.json_out.parent.mkdir(parents=True, exist_ok=True)
        args.json_out.write_text(json.dumps(results, indent=1))
        print(f"wrote {args.json_out}", flush=True)
    return results


if __name__ == "__main__":
    main()
