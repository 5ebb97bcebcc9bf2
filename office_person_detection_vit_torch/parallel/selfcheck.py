"""Scale-out self-check: one rank of the sharded steps against the
one-device step, and sharded detection against one forward.

    torchrun --nproc_per_node N -m office_person_detection_vit_torch.parallel.selfcheck MODE OUT_DIR [cuda|cpu]

MODE ``dp``: an (N, 1) grid; ``tp``: a (1, N) grid. Every rank builds the
same seeded tiny models and batch, runs the one-device step on the whole
batch, then the sharded step (``make_sharded_train_step`` for DETR with
dropout and augmentation, ``make_yolo_sharded_train_step`` for YOLOv8) and
``make_sharded_detect``, and writes ``OUT_DIR/rank{r}.json``: the largest
differences (losses relative, parameters and EMA relative to max(1,
|leaf|), detections absolute). The process group comes from ``torchrun``'s
environment (NCCL on the card, one card a rank; gloo on the CPU).
"""

from __future__ import annotations

import copy
import json
import sys

import numpy as np
import torch
import torch.distributed as dist


def batch(rng: np.random.Generator, B: int, H: int, W: int, device, mask: bool = True) -> dict:
    out = {"pixels": torch.from_numpy(rng.normal(size=(B, H, W, 3)).astype(np.float32)),
           "labels": torch.ones(B, 3, dtype=torch.int32),
           "boxes": torch.from_numpy(np.concatenate([rng.uniform(0.3, 0.7, (B, 3, 2)), rng.uniform(0.1, 0.5, (B, 3, 2))],
                                                    -1).astype(np.float32)),
           "valid": torch.from_numpy(rng.uniform(size=(B, 3)) < 0.7) | (torch.arange(3) == 0)}
    if mask:
        m = torch.ones(B, H, W, dtype=torch.bool)
        m[::2, :, W - 16:] = False  # letterboxed frames
        out["pixel_mask"] = m
    return {k: v.to(device) for k, v in out.items()}


def rel(a, b) -> float:
    return max(((x.detach().double().cpu() - y.detach().double().cpu()).abs().max()
                / y.detach().double().abs().max().clamp(min=1.0)).item() for x, y in zip(a, b))


def compare_steps(make_single, make_sharded, model, mesh, data: dict) -> dict:
    from office_person_detection_vit_torch.parallel.sharding import gather_full, shard_model
    from office_person_detection_vit_torch.training import TrainState, make_optimizer

    other = copy.deepcopy(model)
    before = [p.detach().clone() for p in TrainState.create(copy.deepcopy(model), make_optimizer()).params]
    single_tx, sharded_tx = make_optimizer(learning_rate=1e-4), make_optimizer(learning_rate=1e-4)
    s1 = TrainState.create(model, single_tx, ema=True)
    s1, m1 = make_single(model, single_tx)(s1, data, torch.Generator().manual_seed(5))
    shard_model(other, mesh)
    s2 = TrainState.create(other, sharded_tx, ema=True)
    s2, m2 = make_sharded(other, sharded_tx, mesh)(s2, data, torch.Generator().manual_seed(5))
    return {"loss": abs(m1["loss"].item() - m2["loss"].item()) / max(1.0, abs(m1["loss"].item())),
            "metrics": sorted(m1) == sorted(m2),
            "params": rel(gather_full(s2.params, s2.keys, mesh), s1.params),
            "ema": rel(gather_full(s2.ema_params, s2.keys, mesh), s1.ema_params),
            "moved": sum(not torch.equal(a, b) for a, b in zip(s1.params, before)) > len(before) // 2}


def main(mode: str, out_dir: str, device: str = "cuda") -> None:
    from office_person_detection_vit_torch.models.detr import DETR, DETRConfig
    from office_person_detection_vit_torch.models.postprocess import postprocess_detr
    from office_person_detection_vit_torch.models.yolo import YOLOConfig, YOLOv8
    from office_person_detection_vit_torch.ops.preprocessing import preprocess_frames
    from office_person_detection_vit_torch.parallel import make_mesh, make_sharded_detect
    from office_person_detection_vit_torch.parallel.mesh import initialize_distributed
    from office_person_detection_vit_torch.training import (AugmentConfig, make_sharded_train_step, make_train_step,
                                                            make_yolo_sharded_train_step, make_yolo_train_step)

    torch.set_num_threads(1)
    initialize_distributed(backend="nccl" if device == "cuda" else "gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    mesh = make_mesh(world, model_parallel=world if mode == "tp" else 1)
    results = {"shape": mesh.shape}
    H, W, B = 64, 96, 2 * world
    aug = AugmentConfig(content_w=W - 16)

    detr = DETR(DETRConfig.tiny(num_classes=3, dropout=0.1))
    detr.init_weights(torch.Generator().manual_seed(1))
    detr.to(dev)
    results["detr"] = compare_steps(
        lambda m, tx: make_train_step(m, tx, ema_decay=0.9, augment=aug),
        lambda m, tx, mesh: make_sharded_train_step(m, tx, mesh, ema_decay=0.9, augment=aug),
        detr, mesh, batch(np.random.default_rng(2), B, H, W, dev))

    yolo = YOLOv8(YOLOConfig.tiny())
    yolo.init_weights(torch.Generator().manual_seed(3))
    yolo.to(dev)
    hw = (64, 128)
    results["yolo"] = compare_steps(
        lambda m, tx: make_yolo_train_step(m, tx, hw, ema_decay=0.9, augment=aug, content_hw=(54, 128)),
        lambda m, tx, mesh: make_yolo_sharded_train_step(m, tx, mesh, hw, ema_decay=0.9, augment=aug,
                                                         content_hw=(54, 128)),
        yolo, mesh, {k: v for k, v in batch(np.random.default_rng(4), B, *hw, dev, mask=False).items()})

    model = DETR(DETRConfig.tiny(num_classes=3)).eval()
    model.init_weights(torch.Generator().manual_seed(6))
    model.to(dev)
    frames = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (B, 72, 96, 3), np.uint8)).to(dev)
    with torch.inference_mode():
        pixels, mask = preprocess_frames(frames, target_hw=(H, W))
        o = model(pixels, mask)
        want = postprocess_detr(o["logits"], o["boxes"], (96, 72), 0.0, person_class_id=model.config.person_class_id)
    got = make_sharded_detect(copy.deepcopy(model), mesh, (H, W), 0.0, tensor_parallel=mode == "tp")(frames, (96, 72))
    results["detect"] = {name: float(np.abs(np.asarray(getattr(got, name), np.float64)
                                            - np.asarray(getattr(want, name), np.float64)).max())
                         for name in ("boxes_xywh", "scores", "valid", "foot")}
    total = torch.ones(1, device=dev)
    dist.all_reduce(total)  # the backend's collective over the whole group
    results["all_reduce"] = total.item()
    results["backend"] = dist.get_backend()
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
