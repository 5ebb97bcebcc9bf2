"""Fine-tune the DETR or YOLOv8 detector on a COCO-format dataset, on the card.

The port's counterpart of the repo's ``tools/train_detr.py`` (same flags): a
COCO folder -> ``COCOBatchLoader`` -> preprocessing and the train step
(``training/``) -> ``weights.npz`` (the flat ``leaf_i`` npz that the port's
detectors and the JAX package's ``load_any_checkpoint`` read),
``history.json``, and ``train_state.npz`` with ``train_state_meta.json`` for
``--resume-from``. Run it as

    python -m office_person_detection_vit_torch.train_detr --images DIR \\
        --annotations coco.json [--epochs 10] [--batch 8] [--height 768] \\
        [--width 1344] [--checkpoint out_dir] [--init weights] [--device cpu]

It runs on the card (``--device auto``/``cuda``; no card raises) unless
``--device cpu`` is given; ``--device`` takes the place of ``--platform``.
The full size is DETR-R50 with bf16 compute and float32 master weights;
``--model-size small``/``tiny`` train in float32. ``--backbone vit`` trains
the ViT DETR (ViT-base at ``--patch-size`` at full size, the tiny ViT in the
tiny and small tiers), its attention's gradient through B.4 as the
transformer's. ``--model yolo`` trains YOLOv8 (``--yolo-variant``, bf16
compute with float32 master weights; ``--tiny`` the tiny variant in float32)
with the YOLO criterion, from ``--init`` (the port's npz or an ultralytics
``.pt`` state dict) or a seeded init; its ground truth is normalised to the
letterboxed content (``content_hw``), and the batch has no pixel mask.
``--evaluate`` scores P/R/F1 and AP with the port's ``DetectionBenchmark``
before training and after the last epoch (and every ``--eval-every`` epochs)
into ``history.json``.

Scale-out (``parallel/``): under ``torchrun --nproc_per_node N`` every rank
loads the same batches and runs the sharded step
(``make_sharded_train_step``, or ``make_yolo_sharded_train_step``, data
parallel only) over a (data, model) grid with ``--model-parallel`` model
ranks; rank 0 writes the outputs. As in JAX, one process (or a batch the
data axis does not divide) runs the one-device step.

``--resume-from`` takes the port's own ``train_state.npz`` (keyed by
state_dict key) and the flat ``leaf_i`` one the JAX trainer writes
(:func:`load_jax_train_state`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device

logger = logging.getLogger("train_detr")

#: Resolution every frame is resized to before the letterbox (the pipeline's
#: 1280x720 input).
EVAL_WH = (1280, 720)

def evaluate_detector(model, samples, *, target_hw, cfg, device, batch: int = 8, conf: float = 0.25,
                      iou: float = 0.5, nms_iou: float | None = None, is_yolo: bool = False):
    """Score the model on COCO samples with the port's DetectionBenchmark
    (P/R/F1, AP@50/75, mAP@[.5:.95]), as the JAX trainer's
    ``evaluate_detector``: each image resized to EVAL_WH, batches padded to
    ``batch`` with their first image, one forward and decode a batch on
    ``device`` (``decode_yolo`` with ``is_yolo``); boxes scored in EVAL_WH
    pixels. -> BenchmarkResult."""
    import cv2

    from .benchmark.detection_benchmark import DetectionBenchmark, DetectionRecord
    from .models.postprocess import postprocess_detr
    from .models.yolo import decode_yolo
    from .ops.preprocessing import preprocess_frames

    was_training = model.training
    model.eval()
    records = []
    try:
        for start in range(0, len(samples), batch):
            chunk = samples[start: start + batch]
            n = len(chunk)
            imgs = []
            for path, _, _ in chunk + [chunk[0]] * (batch - n):
                img = cv2.imread(str(path))
                imgs.append(cv2.resize(img if img is not None else np.zeros((720, 1280, 3), np.uint8), EVAL_WH))
            with torch.inference_mode():
                frames = torch.from_numpy(np.stack(imgs)).to(device)
                pixels, mask = preprocess_frames(frames, target_hw=target_hw, out_dtype=cfg.torch_dtype)
                if is_yolo:
                    det = decode_yolo(model(pixels), EVAL_WH, target_hw, cfg, conf)
                else:
                    out = model(pixels, mask)
                    det = postprocess_detr(out["logits"], out["boxes"], EVAL_WH, conf, score_mode=cfg.score_mode,
                                           nms_iou=nms_iou)
            for f in range(n):
                for q in np.flatnonzero(det.valid[f]):
                    records.append(DetectionRecord(str(chunk[f][0]), tuple(float(v) for v in det.boxes_xywh[f, q]),
                                                   float(det.scores[f, q])))
    finally:
        model.train(was_training)
    w, h = EVAL_WH
    gt = {}
    for path, bxs, _ in samples:
        gt[str(path)] = np.stack([(bxs[:, 0] - bxs[:, 2] / 2) * w, (bxs[:, 1] - bxs[:, 3] / 2) * h,
                                  bxs[:, 2] * w, bxs[:, 3] * h], axis=-1).astype(np.float32).reshape(-1, 4)
    return DetectionBenchmark(iou_threshold=iou).evaluate(records, gt)


def load_coco_dataset(images_dir: Path, annotations: Path):
    """-> list of (image_path, boxes_cxcywh_norm (N, 4), labels)."""
    doc = json.loads(annotations.read_text())
    images = {img["id"]: img for img in doc["images"]}
    per_image: dict[int, list] = {img_id: [] for img_id in images}
    for ann in doc.get("annotations", []):
        if ann["image_id"] in per_image:
            per_image[ann["image_id"]].append(ann)
    samples = []
    for img_id, anns in per_image.items():
        info = images[img_id]
        path = images_dir / info["file_name"]
        if not path.exists():
            continue
        w, h = float(info["width"]), float(info["height"])
        boxes, labels = [], []
        for ann in anns:
            x, y, bw, bh = ann["bbox"]
            boxes.append([(x + bw / 2) / w, (y + bh / 2) / h, bw / w, bh / h])
            labels.append(int(ann.get("category_id", 1)))
        samples.append((path, np.asarray(boxes, np.float32).reshape(-1, 4), labels))
    return samples


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Fine-tune DETR (PyTorch/CUDA port)")
    parser.add_argument("--images", required=True, type=Path)
    parser.add_argument("--annotations", required=True, type=Path)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--height", type=int, default=768)
    parser.add_argument("--width", type=int, default=1344)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--checkpoint", type=Path, default=Path("runs/detr_ft"))
    parser.add_argument("--init", type=Path, default=None,
                        help="initial weights (flat or path-keyed .npz, HF .pt/.bin/.safetensors)")
    parser.add_argument("--model-parallel", type=int, default=1,
                        help="tensor-parallel ranks (model axis) under torchrun; the rest split the batch")
    parser.add_argument("--max-targets", type=int, default=32)
    parser.add_argument("--tiny", action="store_true", help="tiny model (smoke tests)")
    parser.add_argument("--model-size", choices=["full", "small", "tiny"], default=None,
                        help="DETR capacity tier; --tiny is shorthand for --model-size tiny")
    parser.add_argument("--model", choices=["detr", "yolo"], default="detr",
                        help="detr (set loss) or yolo (YOLOv8, BCE + CIoU + DFL)")
    parser.add_argument("--yolo-variant", default="s", help="YOLO family size n|s|m|l|x (--model yolo)")
    parser.add_argument("--backbone", choices=["resnet50", "vit"], default="resnet50",
                        help="detector backbone (vit = models/vit.py; --patch-size sets its stride)")
    parser.add_argument("--patch-size", type=int, default=16)
    parser.add_argument("--enc-layers", type=int, default=None, help="override encoder depth")
    parser.add_argument("--dec-layers", type=int, default=None, help="override decoder depth")
    parser.add_argument("--dilate-c5", action="store_true", help="DETR-DC5: dilate the last stage")
    parser.add_argument("--class-loss", choices=("ce", "focal"), default="ce",
                        help="'ce' softmax CE with eos down-weighting; 'focal' per-class sigmoid focal "
                             "(with the prior-bias head init and sigmoid scores)")
    parser.add_argument("--w-class", type=float, default=None,
                        help="classification loss weight (default 1.0 for ce, 2.0 for focal)")
    parser.add_argument("--focal-alpha", type=float, default=0.25)
    parser.add_argument("--remat", action="store_true",
                        help="rerun each transformer layer in the backward (less memory, one more forward)")
    parser.add_argument("--dropout", type=float, default=None,
                        help="transformer dropout (default 0.1 full size, 0.0 small and tiny)")
    parser.add_argument("--save-every", type=int, default=1, help="save a train state every N epochs")
    parser.add_argument("--seed", type=int, default=0, help="seed of init, shuffling and the step's draws")
    parser.add_argument("--schedule", choices=["none", "cosine", "step"], default="none")
    parser.add_argument("--warmup-steps", type=int, default=0)
    parser.add_argument("--backbone-lr-scale", type=float, default=0.1,
                        help="backbone LR as a fraction of --lr")
    parser.add_argument("--drop-at", type=int, default=None, help="step of the --schedule step drop")
    parser.add_argument("--accum-steps", type=int, default=1,
                        help="gradient accumulation micro-steps per update")
    parser.add_argument("--ema", type=float, default=0.0,
                        help="EMA decay of a weight average (0 = off); weights.npz then holds the EMA")
    parser.add_argument("--augment", action="store_true", help="flip + photometric augmentation on the card")
    parser.add_argument("--evaluate", action="store_true",
                        help="score P/R/F1 + AP@50/75 + mAP on the val set (history.json)")
    parser.add_argument("--eval-every", type=int, default=0, help="evaluate every N epochs (0 = last only)")
    parser.add_argument("--eval-conf", type=float, default=0.25, help="confidence threshold of --evaluate")
    parser.add_argument("--eval-iou", type=float, default=0.5)
    parser.add_argument("--eval-nms", type=float, default=None, help="greedy NMS IoU during --evaluate")
    parser.add_argument("--val-images", type=Path, default=None, help="val image dir (default: --images)")
    parser.add_argument("--val-annotations", type=Path, default=None,
                        help="val COCO json (default: --annotations)")
    parser.add_argument("--resume-from", type=Path, default=None,
                        help="resume from a train_state.npz this trainer or the JAX trainer saved")
    parser.add_argument("--device", default="auto",
                        help="auto | cuda | cuda:N | cpu (auto and cuda need a card)")
    return parser.parse_args(argv)


def detr_config(args: argparse.Namespace, size: str):
    """The JAX trainer's DETRConfig for these flags: the tiny and small tiers
    in float32, full size in bf16."""
    from .models.detr import DETRConfig
    from .models.vit import ViTConfig

    extra: dict = {}
    if args.backbone == "vit":
        extra = dict(backbone="vit", vit_patch_size=args.patch_size)
        if size == "tiny":
            t = ViTConfig.tiny()
            extra.update(vit_patch_size=min(args.patch_size, t.patch_size), vit_hidden=t.hidden_size,
                         vit_layers=t.num_layers, vit_heads=t.num_heads, vit_mlp=t.mlp_dim, vit_pos_grid=t.pos_grid)
    if args.dropout is not None:
        extra["dropout"] = args.dropout
    if args.dilate_c5:
        extra["dilate_c5"] = True
    if args.class_loss == "focal":
        extra["class_prior"] = 0.01
        extra["score_mode"] = "sigmoid"
    if args.enc_layers is not None:
        extra["num_encoder_layers"] = args.enc_layers
    if args.dec_layers is not None:
        extra["num_decoder_layers"] = args.dec_layers
    if size in ("tiny", "small"):
        return getattr(DETRConfig, size)(remat=args.remat, **extra)
    return DETRConfig(dtype="bfloat16", remat=args.remat, **extra)


def save_train_state(path: Path, state) -> None:
    """The port's train state: step and optimizer counters, then params, Adam
    moments, the accumulated gradient and the EMA, keyed by state_dict key."""
    opt = state.opt_state
    arrays = {"meta/step": np.int64(state.step), "meta/count": np.int64(opt.count),
              "meta/mini_step": np.int64(opt.mini_step)}
    groups = {"param": state.params, "mu": opt.mu, "nu": opt.nu, "acc": opt.acc, "ema": state.ema_params}
    for group, tensors in groups.items():
        if tensors is not None:
            for key, t in zip(state.keys, tensors):
                arrays[f"{group}/{key}"] = t.detach().float().cpu().numpy()
    np.savez(path, **arrays)


def load_train_state(path: Path, state, tx, mesh=None) -> None:
    """Restore a saved train state into ``state`` in place: the port's own
    npz, or the JAX trainer's (:func:`load_jax_train_state`). A checkpoint
    without an EMA resumed with ``--ema`` restarts the average from the
    resumed weights; an EMA checkpoint resumed without ``--ema`` drops it.
    A different model or ``--accum-steps`` raises. With a tensor-parallel
    ``mesh`` each tensor of the port's npz is cut to this rank's part."""
    from .parallel.sharding import shard, spec_of

    opt = state.opt_state
    with np.load(path) as data:
        files = set(data.files)
        if "leaf_0" in files:
            if mesh is not None and mesh.model_parallel > 1:
                raise ValueError(f"{path}: a JAX train state resumes on one model rank (--model-parallel 1)")
            return load_jax_train_state(path, state, tx)
        want = {f"param/{k}" for k in state.keys}
        if not want <= files:
            raise ValueError(f"{path} holds another model's train state ({len(want - files)} params missing)")
        if any(f.startswith("acc/") for f in files) != (opt.acc is not None):
            raise ValueError(f"{path}: the optimizer configuration (e.g. --accum-steps) must match the saving run")

        def restore(group: str, tensors) -> None:
            with torch.no_grad():
                for key, t in zip(state.keys, tensors):
                    arr = data[f"{group}/{key}"]
                    if mesh is not None:
                        arr = shard(torch.from_numpy(arr), spec_of(key), mesh.model_index, mesh.model_parallel)
                    if tuple(arr.shape) != tuple(t.shape):
                        raise ValueError(f"{path}: {group}/{key} has shape {arr.shape}, expected {tuple(t.shape)}")
                    t.copy_(torch.as_tensor(arr))

        for group, tensors in (("param", state.params), ("mu", opt.mu), ("nu", opt.nu), ("acc", opt.acc)):
            if tensors is not None:
                restore(group, tensors)
        has_ema = any(f.startswith("ema/") for f in files)
        if state.ema_params is not None:
            if has_ema:
                restore("ema", state.ema_params)
            else:
                logger.info("resumed checkpoint has no EMA; restarting the average from the resumed weights")
                for e, p in zip(state.ema_params, state.params):
                    e.copy_(p.detach())
        elif has_ema:
            logger.info("resumed checkpoint carries EMA weights; --ema 0 drops them")
        state.step = int(data["meta/step"])
        opt.count = int(data["meta/count"])
        opt.mini_step = int(data["meta/mini_step"])


def jax_state_layout(state, tx, ema: bool) -> list[tuple[str, int | None]]:
    """The leaves of the JAX trainer's ``TrainState`` for this model and
    optimizer, in ``jax.tree_util`` order, as (group, parameter index or
    ``None`` for a scalar): ``step``, the params, the optimizer state, then
    the EMA. The optimizer state is optax's ``MultiSteps`` (``mini_step``,
    ``gradient_step``, the inner state, the accumulated gradient) around
    ``chain(clip_by_global_norm, multi_transform)``, whose inner states come
    in label order (``backbone``, ``main``): Adam's count, mu and nu over the
    group's leaves, and a schedule count when the learning rate is a
    schedule."""
    n = len(state.keys)
    groups = {"backbone": [i for i, k in enumerate(state.keys) if k.startswith("backbone.")],
              "main": [i for i, k in enumerate(state.keys) if not k.startswith("backbone.")]}
    inner = []
    for idx in groups.values():
        inner += [("count", None)] + [("mu", i) for i in idx] + [("nu", i) for i in idx]
        if tx.scheduled:
            inner.append(("schedule_count", None))
    if tx.accum_steps > 1:
        inner = [("mini_step", None), ("gradient_step", None), *inner] + [("acc", i) for i in range(n)]
    out = [("step", None)] + [("param", i) for i in range(n)] + inner
    return out + ([("ema", i) for i in range(n)] if ema else [])


def load_jax_train_state(path: Path, state, tx) -> None:
    """Restore a ``train_state.npz`` of the JAX trainer (its flat ``leaf_i``
    npz, ``tools/train_detr.py::_save_pytree``) into ``state`` in place. The
    leaf order comes from :func:`jax_state_layout`; as in the JAX trainer, a
    state saved with an EMA resumes without one and the reverse (the
    average then restarts from the resumed weights). Another model, another
    ``--accum-steps`` or another kind of schedule raises."""
    opt = state.opt_state
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    want_ema = state.ema_params is not None
    layout = None
    for ema in (want_ema, not want_ema):
        candidate = jax_state_layout(state, tx, ema)
        if len(candidate) == len(leaves):
            layout, has_ema = candidate, ema
            break
    if layout is None:
        raise ValueError(f"{path} holds {len(leaves)} leaves; this model and optimizer's JAX train state has "
                         f"{len(jax_state_layout(state, tx, want_ema))} (another model, --accum-steps or schedule?)")
    from .models.weights import flax_param_map

    entries = flax_param_map(state.model.config)  # the order of state.keys
    targets = {"param": state.params, "mu": opt.mu, "nu": opt.nu, "acc": opt.acc,
               "ema": state.ema_params if has_ema and want_ema else None}
    scalars: dict[str, int] = {}
    with torch.no_grad():
        for i, ((group, j), arr) in enumerate(zip(layout, leaves)):
            if j is None:
                if arr.shape != ():
                    raise ValueError(f"{path}: leaf_{i} ({group}) has shape {arr.shape}, expected a scalar")
                scalars.setdefault(group, int(arr))
                continue
            e = entries[j]
            if tuple(arr.shape) != e.flax_shape:
                raise ValueError(f"{path}: leaf_{i} ({group} of {'/'.join(e.flax_path)}) has shape {arr.shape}, "
                                 f"expected {e.flax_shape} (another model?)")
            if e.kind == "conv":  # Flax HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif e.kind == "dense":  # Flax (in, out) -> (out, in)
                arr = arr.T
            if targets[group] is not None:
                targets[group][j].copy_(torch.from_numpy(np.ascontiguousarray(arr, np.float32)))
        if want_ema and not has_ema:
            logger.info("resumed checkpoint has no EMA; restarting the average from the resumed weights")
            for e, p in zip(state.ema_params, state.params):
                e.copy_(p.detach())
        elif has_ema and not want_ema:
            logger.info("resumed checkpoint carries EMA weights; --ema 0 drops them")
    state.step = scalars["step"]
    opt.count = scalars["count"]
    opt.mini_step = scalars.get("mini_step", 0)


def build_model(args: argparse.Namespace, size: str, target_hw: tuple[int, int]):
    """The model of these flags with its seeded init or ``--init``, its
    config, and the one-device and sharded step factories (each
    ``(model, tx, [mesh,] **step_kwargs)``), as the JAX trainer builds them."""
    from .models.weights import load_checkpoint
    from .training import make_sharded_train_step, make_train_step

    if args.model == "yolo":
        from .models.weights import convert_yolov8_state_dict, state_dict_from_flax
        from .models.yolo import YOLOConfig, YOLOv8
        from .ops.preprocessing import compute_resize_geometry
        from .training import make_yolo_sharded_train_step, make_yolo_train_step

        cfg = YOLOConfig.tiny() if size == "tiny" else YOLOConfig(variant=args.yolo_variant)
        model = YOLOv8(cfg)
        model.init_weights(torch.Generator().manual_seed(args.seed))
        if args.init:
            if args.init.exists():
                if args.init.suffix in (".pt", ".pth", ".bin"):
                    sd = torch.load(str(args.init), map_location="cpu", weights_only=True)
                    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
                        sd = sd["model"]
                    model.load_state_dict(state_dict_from_flax(convert_yolov8_state_dict(sd), cfg))
                else:
                    model.load_state_dict(load_checkpoint(args.init, cfg))
                logger.info("initialized from %s", args.init)
            else:
                logger.warning("--init %s not found; training from random init", args.init)
        # GT boxes are normalised to the source frame, the letterboxed valid
        # content; the criterion scales them by its extent (the grid spans
        # the canvas).
        content_hw = compute_resize_geometry((EVAL_WH[1], EVAL_WH[0]), target_hw)
        return (model, cfg,
                lambda m, t, **kw: make_yolo_train_step(m, t, target_hw, content_hw=content_hw, **kw),
                lambda m, t, mesh, **kw: make_yolo_sharded_train_step(m, t, mesh, target_hw, content_hw=content_hw,
                                                                      **kw))
    from .models.detr import DETR

    cfg = detr_config(args, size)
    model = DETR(cfg)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    if args.init:
        if args.init.exists():
            model.load_state_dict(load_checkpoint(args.init, cfg))
            logger.info("initialized from %s", args.init)
        else:
            logger.warning("--init %s not found; training from random init", args.init)
    return model, cfg, make_train_step, make_sharded_train_step


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    size = args.model_size or ("tiny" if args.tiny else "full")
    args.tiny = size == "tiny"
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    is_yolo = args.model == "yolo"

    from .models.weights import save_flat_npz
    from .ops.preprocessing import preprocess_frames
    from .parallel.mesh import initialize_distributed, make_mesh, world
    from .parallel.sharding import gather_full, shard_model
    from .training import AugmentConfig, COCOBatchLoader, CriterionConfig, TrainState, content_width, make_optimizer

    samples = load_coco_dataset(args.images, args.annotations)
    if not samples:
        logger.error("no usable samples under %s", args.images)
        return 1
    if len(samples) < args.batch:
        logger.warning("dataset (%d) smaller than --batch %d; clamping batch", len(samples), args.batch)
        args.batch = len(samples)
    logger.info("dataset: %d images", len(samples))
    target_hw = (args.height, args.width)

    initialize_distributed()  # under torchrun; one process is left as it is
    rank, n_dev = world()
    model, cfg, make_single, make_sharded = build_model(args, size, target_hw)
    device = resolve_device(args.device, cfg.dtype)
    data_parallel = n_dev // args.model_parallel
    mesh = None
    if n_dev > 1 and args.batch % max(data_parallel, 1) == 0:
        mesh = make_mesh(n_dev, model_parallel=args.model_parallel)
        model = shard_model(model, mesh)
    elif n_dev > 1 or args.model_parallel > 1:
        logger.warning("batch %d over %d rank(s) with --model-parallel %d: one-device step", args.batch, n_dev,
                       args.model_parallel)
    model.to(device)  # float32 parameters; the forward computes in cfg.dtype

    steps_per_epoch = max(1, len(samples) // args.batch)
    tx = make_optimizer(
        learning_rate=args.lr, backbone_lr=args.lr * args.backbone_lr_scale,
        schedule=None if args.schedule == "none" else args.schedule,
        total_steps=args.epochs * steps_per_epoch, warmup_steps=args.warmup_steps,
        drop_at=args.drop_at, accum_steps=args.accum_steps,
    )
    use_ema = args.ema > 0
    state = TrainState.create(model, tx, ema=use_ema)
    aug_cfg = AugmentConfig(content_w=content_width(target_hw)) if args.augment else None
    step_kwargs: dict = dict(ema_decay=args.ema if use_ema else None, augment=aug_cfg)
    if not is_yolo and (args.class_loss == "focal" or args.w_class is not None):
        default_w = 2.0 if args.class_loss == "focal" else 1.0
        step_kwargs["criterion"] = CriterionConfig(
            num_classes=cfg.num_classes, class_loss=args.class_loss,
            w_class=args.w_class if args.w_class is not None else default_w,
            focal_alpha=args.focal_alpha,
        )
    start_epoch = 0
    if args.resume_from and args.resume_from.exists():
        load_train_state(args.resume_from, state, tx, mesh)
        meta = args.resume_from.parent / "train_state_meta.json"
        if meta.exists():
            start_epoch = json.loads(meta.read_text()).get("epoch", 0)
        logger.info("resumed train state from %s (epoch %d)", args.resume_from, start_epoch)
    step = make_sharded(model, tx, mesh, **step_kwargs) if mesh is not None else make_single(model, tx, **step_kwargs)

    if not is_yolo and args.max_targets > cfg.num_queries:
        logger.warning("--max-targets %d exceeds the model's %d queries; clamping (images with more "
                       "than %d boxes lose the excess)", args.max_targets, cfg.num_queries, cfg.num_queries)
        args.max_targets = cfg.num_queries
    loader = COCOBatchLoader(samples, args.batch, capacity=args.max_targets, resize_wh=EVAL_WH,
                             seed=args.seed, depth=2)

    def to_device(host_batch: dict) -> dict:
        frames = torch.from_numpy(host_batch["frames_u8"]).to(device)
        pixels, mask = preprocess_frames(frames, target_hw=target_hw, out_dtype=cfg.torch_dtype)
        batch = {"pixels": pixels} if is_yolo else {"pixels": pixels, "pixel_mask": mask}  # YOLO takes no mask
        for k in ("labels", "boxes", "valid"):
            batch[k] = torch.from_numpy(host_batch[k]).to(device)
        return batch

    def full(tensors):
        return tensors if mesh is None or tensors is None else gather_full(tensors, state.keys, mesh)

    def save_state(epoch: int) -> None:
        saved = dataclasses.replace(state, params=full(state.params), ema_params=full(state.ema_params),
                                    opt_state=dataclasses.replace(state.opt_state, mu=full(state.opt_state.mu),
                                                                  nu=full(state.opt_state.nu),
                                                                  acc=full(state.opt_state.acc)))
        if rank == 0:
            args.checkpoint.mkdir(parents=True, exist_ok=True)
            save_train_state(args.checkpoint / "train_state.npz", saved)
            (args.checkpoint / "train_state_meta.json").write_text(json.dumps({"epoch": epoch}))

    history_path = args.checkpoint / "history.json"
    history: dict = {"step_losses": [], "epoch_losses": [], "config": {
        "batch": args.batch, "lr": args.lr, "devices": n_dev,
        "data_parallel": int(max(data_parallel, 1)) if mesh is not None else 1,
        "model_parallel": args.model_parallel, "tiny": args.tiny, "model_size": size,
        "schedule": args.schedule, "warmup_steps": args.warmup_steps,
        "accum_steps": args.accum_steps, "ema": args.ema, "augment": bool(args.augment),
        "class_loss": args.class_loss, "w_class": args.w_class, "focal_alpha": args.focal_alpha,
        "backbone_lr_scale": args.backbone_lr_scale, "eval_nms": args.eval_nms,
        "max_targets": args.max_targets, "enc_objectness": bool(not is_yolo and cfg.enc_objectness),
        "device": str(device),
    }}
    if args.resume_from and history_path.exists():
        prev = json.loads(history_path.read_text())
        history["step_losses"] = prev.get("step_losses", [])
        history["epoch_losses"] = prev.get("epoch_losses", [])
        if prev.get("evals"):
            history["evals"] = prev["evals"]
        history["resumed_at_step"] = len(history["step_losses"])

    val_samples = samples
    if args.val_images or args.val_annotations:
        val_samples = load_coco_dataset(args.val_images or args.images, args.val_annotations or args.annotations)

    def run_eval(epoch: int) -> None:
        """Score the EMA weights when tracked (the served weights), else the
        parameters; the parameters are put back afterwards. Every rank runs
        it (a tensor-parallel forward needs them all)."""
        kept = None
        if use_ema:
            with torch.no_grad():
                kept = [p.detach().clone() for p in state.params]
                for p, e in zip(state.params, state.ema_params):
                    p.copy_(e)
        try:
            res = evaluate_detector(model, val_samples, target_hw=target_hw, cfg=cfg, device=device,
                                    batch=min(args.batch, len(val_samples)), conf=args.eval_conf, iou=args.eval_iou,
                                    nms_iou=args.eval_nms, is_yolo=is_yolo)
        finally:
            if kept is not None:
                with torch.no_grad():
                    for p, k in zip(state.params, kept):
                        p.copy_(k)
        history.setdefault("evals", []).append({"epoch": epoch, **res.to_dict()})
        logger.info("eval epoch %d: P %.3f R %.3f F1 %.3f AP50 %.3f mAP %.3f (tp %d fp %d fn %d)", epoch,
                    res.precision, res.recall, res.f1, res.ap50, res.map_5095, res.tp, res.fp, res.fn)

    if args.evaluate:
        run_eval(start_epoch)  # the baseline before training (epoch = start)

    # Full-batch runs (batch x accum covers the dataset) reuse epoch 0's
    # device batches: every epoch is the same batch, and augmentation still
    # draws anew each step.
    cache_device_batch = args.batch * args.accum_steps >= len(samples)
    device_batches: list | None = None
    generator = torch.Generator().manual_seed(args.seed + 1)

    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        losses, comps = [], {}
        if cache_device_batch and device_batches is not None:
            batches = device_batches
        else:
            batches = (to_device(b) for b in loader.epoch(epoch))
            if cache_device_batch:
                batches = device_batches = list(batches)
        for batch in batches:
            state, metrics = step(state, batch, generator)
            losses.append(metrics["loss"])
            for k, v in metrics.items():
                if k != "loss":
                    comps.setdefault(k, []).append(v)
        losses = [float(v) for v in losses]
        comp_means = {k: float(torch.stack(v).float().mean()) for k, v in comps.items()}
        logger.info("epoch %d/%d: loss %.4f [%s] (%.1fs)", epoch + 1, args.epochs,
                    float(np.mean(losses)) if losses else float("nan"),
                    " ".join(f"{k}={v:.3f}" for k, v in sorted(comp_means.items())),
                    time.perf_counter() - t0)
        history["step_losses"].extend(losses)
        history["epoch_losses"].append(float(np.mean(losses)) if losses else None)
        history.setdefault("epoch_metrics", []).append(comp_means)
        if args.evaluate and (epoch + 1 == args.epochs or (args.eval_every and (epoch + 1) % args.eval_every == 0)):
            run_eval(epoch + 1)
        if rank == 0:
            args.checkpoint.mkdir(parents=True, exist_ok=True)
            history_path.write_text(json.dumps(history))
        if (epoch + 1) % args.save_every == 0:
            save_state(epoch + 1)

    weights = full(state.ema_params if use_ema else state.params)
    if rank == 0:
        args.checkpoint.mkdir(parents=True, exist_ok=True)
        ckpt_path = args.checkpoint / "weights.npz"
        save_flat_npz(ckpt_path, dict(zip(state.keys, weights)), cfg)
        logger.info("saved checkpoint -> %s%s", ckpt_path, " (EMA weights)" if use_ema else "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
