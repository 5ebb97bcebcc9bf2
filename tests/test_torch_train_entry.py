"""The port's training entry points on the CPU.

- ``python -m office_person_detection_vit_torch.train_detr --model-size tiny
  --device cpu`` trains one epoch on a small synthetic COCO set
  (``tools/gen_recipe_dataset.py``), writes ``weights.npz``, ``history.json``
  and a train state, and resumes from it;
- that ``weights.npz`` loads into the port's ``DETRDetector`` and into the
  JAX package's ``load_any_checkpoint``; the two models give the same logits
  and boxes within the DETR bar (logits atol 2e-3 / rtol 1e-3, boxes 1e-3);
- the flags the port refuses raise, naming their ROADMAP item;
- ``--backbone vit`` trains the tiny ViT DETR, and ``--evaluate`` scores it
  before and after training as the JAX trainer does;
- a ``train_state.npz`` that the JAX trainer saves resumes in the port
  (ROADMAP C.8): every leaf lands where the JAX state holds it, with an
  accumulated gradient and a schedule count too, and the next step matches
  JAX's (losses within 1e-4 relative, as tests/test_torch_train_step.py);
- the port's ``main --fine-tune`` passes the root ``main.py``'s argument list
  (plus ``--device`` from ``detection.device``) and trains.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from office_person_detection_vit_torch import main as port_main_module
from office_person_detection_vit_torch import train_detr
from office_person_detection_vit_torch.detection.detector import DETRDetector
from office_person_detection_vit_torch.models import detr as port_detr
from office_person_detection_vit_torch.models.weights import load_checkpoint
from office_person_detection_vit_tpu.models import detr as jax_detr
from office_person_detection_vit_tpu.models.weights import load_any_checkpoint
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

REPO = Path(__file__).resolve().parent.parent
HW = (64, 112)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("recipe")
    subprocess.run([sys.executable, str(REPO / "tools" / "gen_recipe_dataset.py"), "--out", str(out),
                    "--train", "6", "--val", "0"], check=True, capture_output=True)
    return out / "train"


def _args(dataset, ckpt, *extra):
    return ["--images", str(dataset / "images"), "--annotations", str(dataset / "coco.json"),
            "--model-size", "tiny", "--device", "cpu", "--batch", "3", "--height", str(HW[0]),
            "--width", str(HW[1]), "--max-targets", "4", "--checkpoint", str(ckpt), *extra]


@pytest.fixture(scope="module")
def trained(dataset, tmp_path_factory):
    """One epoch through ``python -m``, in a child process."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "office_person_detection_vit_torch.train_detr",
                           *_args(dataset, ckpt, "--epochs", "1")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return ckpt


def test_train_detr_writes_weights_history_and_state(trained):
    for name in ("weights.npz", "history.json", "train_state.npz", "train_state_meta.json"):
        assert (trained / name).stat().st_size > 0, name
    history = json.loads((trained / "history.json").read_text())
    assert len(history["step_losses"]) == 2 and len(history["epoch_losses"]) == 1
    assert all(np.isfinite(history["step_losses"]))
    assert history["config"]["model_size"] == "tiny" and history["config"]["device"] == "cpu"
    assert json.loads((trained / "train_state_meta.json").read_text()) == {"epoch": 1}


def test_train_detr_resumes(dataset, trained, tmp_path):
    ckpt = tmp_path / "resumed"
    ckpt.mkdir()
    for name in ("history.json", "train_state.npz", "train_state_meta.json"):
        (ckpt / name).write_bytes((trained / name).read_bytes())
    assert train_detr.main(_args(dataset, ckpt, "--epochs", "2", "--resume-from",
                                 str(ckpt / "train_state.npz"))) == 0
    history = json.loads((ckpt / "history.json").read_text())
    assert history["resumed_at_step"] == 2 and len(history["step_losses"]) == 4
    assert json.loads((ckpt / "train_state_meta.json").read_text()) == {"epoch": 2}
    with np.load(ckpt / "train_state.npz") as data:
        assert int(data["meta/step"]) == 4 and int(data["meta/count"]) == 4
    with pytest.raises(ValueError, match="accum-steps"):
        train_detr.main(_args(dataset, tmp_path / "x", "--epochs", "3", "--accum-steps", "2",
                              "--resume-from", str(ckpt / "train_state.npz")))


def test_weights_load_in_both_packages(trained):
    """The trainer's weights.npz in the port's detector and in the JAX loader:
    the same logits and boxes within the DETR bar."""
    path = trained / "weights.npz"
    det = DETRDetector({"detection.device": "cpu", "detection.checkpoint_path": str(path),
                        "detection.input_height": HW[0], "detection.input_width": HW[1],
                        "detection.confidence_threshold": 0.0},
                       detr_config=port_detr.DETRConfig.tiny())
    det.load_model()
    sd = load_checkpoint(path, det.detr_config)
    assert all(torch.equal(det.model.state_dict()[k], v) for k, v in sd.items())
    frames = np.random.default_rng(0).integers(0, 255, (2, 72, 128, 3), np.uint8)
    batch = det.detect_batch(frames)
    assert batch.valid.shape == (2, 10) and np.isfinite(batch.boxes_xywh).all()

    jcfg = jax_detr.DETRConfig.tiny()
    jmodel = jax_detr.DETR(jcfg)
    template = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)), jnp.ones((1, *HW), bool))
    variables = load_any_checkpoint(path, template=template)
    pixels = np.random.default_rng(1).normal(size=(2, *HW, 3)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(pixels))
    with torch.no_grad():
        got = det.model(torch.from_numpy(pixels))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), atol=1e-3)


REFUSED = {
    "yolo": (["--model", "yolo", "--width", "128"], "A.7"),  # YOLOv8 takes multiples of 32
    "model_parallel": (["--model-parallel", "2"], "A.8"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_flags_name_their_roadmap_item(dataset, tmp_path, case):
    """The two flags the trainer refused until their item landed now train:
    ``--model yolo`` (A.7c) the tiny YOLOv8, whose ``weights.npz`` the
    port's YOLO detector loads; ``--model-parallel 2`` (A.8) in one process
    takes the one-device step, as the JAX trainer does on one device, while
    a mesh of 2 model ranks over 1 raises."""
    flags, item = REFUSED[case]
    ckpt = tmp_path / "ck"
    assert train_detr.main(_args(dataset, ckpt, "--epochs", "1", *flags)) == 0
    history = json.loads((ckpt / "history.json").read_text())
    assert len(history["step_losses"]) == 2 and all(np.isfinite(history["step_losses"]))
    if case == "yolo":
        from office_person_detection_vit_torch.detection.yolo_detector import YOLODetector

        det = YOLODetector({"detection.device": "cpu", "detection.model_size": "tiny",
                            "detection.checkpoint_path": str(ckpt / "weights.npz"),
                            "detection.input_height": HW[0], "detection.input_width": 128})
        det.load_model()
        assert det.detect_batch(np.zeros((1, 72, 128, 3), np.uint8)).scores.shape[0] == 1
    else:
        from office_person_detection_vit_torch.parallel.mesh import make_mesh

        assert history["config"]["model_parallel"] == 2 and history["config"]["devices"] == 1
        with pytest.raises(ValueError, match="must divide"):
            make_mesh(model_parallel=2)


def _fine_tune_config(path, dataset, out, **training):
    cfg = {
        "detection": {"device": "cpu"},
        "training": {"images_dir": str(dataset / "images"), "annotations": str(dataset / "coco.json"),
                     "epochs": 1, "batch_size": 3, "output_dir": str(out), "input_height": HW[0],
                     "input_width": HW[1], "learning_rate": 1e-4, "tiny": True, **training},
    }
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_fine_tune_passes_the_root_main_argument_list(dataset, tmp_path, monkeypatch):
    import main as root_main
    import tools.train_detr as jax_trainer

    cfg = _fine_tune_config(tmp_path / "c.yaml", dataset, tmp_path / "out", remat=True, schedule="step",
                            drop_at=4, warmup_steps=2, accum_steps=2, ema=0.99, augment=True)
    seen = {}
    monkeypatch.setattr(jax_trainer, "main", lambda argv: seen.setdefault("root", argv) and 0)
    monkeypatch.setattr(train_detr, "main", lambda argv: seen.setdefault("port", argv) and 0)
    assert root_main.main(["--config", str(cfg), "--fine-tune"]) == 0
    assert port_main_module.main(["--config", str(cfg), "--fine-tune"]) == 0
    assert seen["port"] == seen["root"] + ["--device", "cpu"]
    assert {"--remat", "--augment", "--tiny", "--ema", "--accum-steps", "--drop-at"} <= set(seen["root"])


def test_fine_tune_trains_and_refuses_yolo(dataset, tmp_path, capsys):
    """``main --fine-tune`` trains DETR, and since A.7c YOLOv8 too
    (``training.model: yolo``; the tiny variant with ``training.tiny``)."""
    cfg = _fine_tune_config(tmp_path / "c.yaml", dataset, tmp_path / "out")
    assert port_main_module.main(["--config", str(cfg), "--fine-tune"]) == 0
    assert (tmp_path / "out" / "weights.npz").stat().st_size > 0
    cfg = _fine_tune_config(tmp_path / "y.yaml", dataset, tmp_path / "y", model="yolo", input_width=128)
    assert port_main_module.main(["--config", str(cfg), "--fine-tune"]) == 0
    from office_person_detection_vit_torch.models.weights import load_checkpoint
    from office_person_detection_vit_torch.models.yolo import YOLOConfig

    assert len(load_checkpoint(tmp_path / "y" / "weights.npz", YOLOConfig.tiny())) > 0


def test_vit_backbone_trains_and_evaluates(dataset, tmp_path):
    """``--backbone vit`` at the tiny tier (the tiny ViT, patch 8) with
    ``--evaluate --eval-every 1``: the baseline and one score an epoch, as
    the JAX trainer writes them, and weights that load as a ViT DETR."""
    ckpt = tmp_path / "vit"
    assert train_detr.main(_args(dataset, ckpt, "--epochs", "2", "--backbone", "vit", "--patch-size", "16",
                                 "--evaluate", "--eval-every", "1", "--eval-conf", "0.0")) == 0
    history = json.loads((ckpt / "history.json").read_text())
    assert [e["epoch"] for e in history["evals"]] == [0, 1, 2]
    keys = {"precision", "recall", "f1_score", "ap_50", "ap_75", "map_50_95", "num_images", "num_gt",
            "true_positives", "false_positives", "false_negatives"}
    assert all(set(e) == keys | {"epoch"} for e in history["evals"])
    assert history["evals"][0]["num_images"] == 6 and all(np.isfinite(history["step_losses"]))
    cfg = port_detr.DETRConfig.tiny(backbone="vit", vit_patch_size=8, vit_hidden=64, vit_layers=2, vit_heads=4,
                                    vit_mlp=128, vit_pos_grid=4)
    sd = load_checkpoint(ckpt / "weights.npz", cfg)
    assert "backbone.cls_token" in sd and "backbone.layer_1.attention.q_proj.weight" in sd


# ------------------------------------------------------------------ C.8
C8_HW, C8_B, C8_T, C8_C = (64, 96), 2, 3, 5


def _c8_batch(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((C8_B, *C8_HW), bool)
    mask[1, :, 80:] = False
    return {
        "pixels": rng.normal(size=(C8_B, *C8_HW, 3)).astype(np.float32),
        "pixel_mask": mask,
        "labels": rng.integers(0, C8_C, (C8_B, C8_T)).astype(np.int32),
        "boxes": np.concatenate([rng.uniform(0.2, 0.8, (C8_B, C8_T, 2)), rng.uniform(0.05, 0.3, (C8_B, C8_T, 2))],
                                -1).astype(np.float32),
        "valid": np.array([[True, True, False], [True, False, False]]),
    }


def _jax_state(opt_kw, ema, randomize, seed=0, **cfg_kw):
    """A JAX tiny DETR and its TrainState; with ``randomize`` every leaf is
    replaced by a seeded random value (scalars by small counts), so that a
    leaf read from the wrong place shows."""
    import dataclasses

    from office_person_detection_vit_tpu.training import train_step as jax_step

    jcfg = jax_detr.DETRConfig.tiny(num_classes=C8_C, **cfg_kw)
    jmodel, variables = jax_detr.init_detr(jcfg, jax.random.PRNGKey(seed), input_hw=C8_HW)
    tx = jax_step.make_optimizer(**opt_kw)
    state = jax_step.TrainState.create(variables["params"], tx, ema=ema)
    if randomize:
        rng = np.random.default_rng(seed + 1)
        state = jax.tree_util.tree_map(
            lambda x: (np.asarray(rng.integers(1, 50), np.asarray(x).dtype) if np.ndim(x) == 0
                       else rng.normal(size=np.shape(x)).astype(np.float32)), jax.device_get(state))
    fields = {f.name for f in dataclasses.fields(port_detr.DETRConfig)}
    pcfg = port_detr.DETRConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    return jmodel, tx, state, pcfg


def _adam_states(opt_state):
    import optax

    def is_adam(x):
        return isinstance(x, optax.ScaleByAdamState)

    return [x for x in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam) if is_adam(x)]


def _port_state(pcfg, opt_kw, ema):
    from office_person_detection_vit_torch.training import train_step as port_step

    model = port_detr.DETR(pcfg)
    model.init_weights(torch.Generator().manual_seed(9))
    tx = port_step.make_optimizer(**opt_kw)
    return port_step.TrainState.create(model, tx, ema=ema), tx


def _port_leaves(state, tensors):
    from office_person_detection_vit_torch.models.weights import flat_leaves_from_state_dict

    return flat_leaves_from_state_dict(dict(zip(state.keys, tensors)), state.model.config)


@pytest.mark.parametrize(
    "opt_kw,saved_ema,resumed_ema",
    [(dict(learning_rate=1e-3, backbone_lr=1e-4), True, True),
     (dict(learning_rate=1e-3, backbone_lr=1e-4, schedule="cosine", total_steps=20, accum_steps=2), False, False),
     (dict(learning_rate=1e-3, backbone_lr=1e-4, warmup_steps=3), True, False),
     (dict(learning_rate=1e-3, backbone_lr=1e-4), False, True)],
    ids=["ema", "accum_cosine", "ema_dropped", "ema_restarted"],
)
def test_jax_train_state_leaves_land_where_jax_holds_them(tmp_path, opt_kw, saved_ema, resumed_ema):
    from tools.train_detr import _save_pytree

    _, _, jstate, pcfg = _jax_state(opt_kw, saved_ema, randomize=True)
    path = tmp_path / "train_state.npz"
    _save_pytree(path, jstate)
    state, tx = _port_state(pcfg, opt_kw, resumed_ema)
    train_detr.load_train_state(path, state, tx)

    def same(got, want_tree):
        want = jax.tree_util.tree_leaves(want_tree)
        assert len(got) == len(want)
        assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(got, want))

    same(_port_leaves(state, state.params), jstate.params)
    adam = _adam_states(jstate.opt_state)
    is_bb = [k.startswith("backbone.") for k in state.keys]
    for group in ("mu", "nu"):
        got = _port_leaves(state, getattr(state.opt_state, group))
        same([a for a, b in zip(got, is_bb) if b], getattr(adam[0], group))
        same([a for a, b in zip(got, is_bb) if not b], getattr(adam[1], group))
    assert state.step == int(jstate.step) and state.opt_state.count == int(adam[0].count)
    if opt_kw.get("accum_steps", 1) > 1:
        same(_port_leaves(state, state.opt_state.acc), jstate.opt_state.acc_grads)
        assert state.opt_state.mini_step == int(jstate.opt_state.mini_step)
    if saved_ema and resumed_ema:
        same(_port_leaves(state, state.ema_params), jstate.ema_params)
    elif resumed_ema:  # restarted from the resumed weights
        same(_port_leaves(state, state.ema_params), jstate.params)


def test_jax_train_state_of_another_model_raises(tmp_path):
    from tools.train_detr import _save_pytree

    opt_kw = dict(learning_rate=1e-3, backbone_lr=1e-4)
    _, _, jstate, _ = _jax_state(opt_kw, False, randomize=False)
    path = tmp_path / "train_state.npz"
    _save_pytree(path, jstate)
    state, tx = _port_state(port_detr.DETRConfig.tiny(num_classes=C8_C, num_queries=12), opt_kw, False)
    with pytest.raises(ValueError, match="another model"):
        train_detr.load_train_state(path, state, tx)
    state, tx = _port_state(port_detr.DETRConfig.tiny(num_classes=C8_C, num_encoder_layers=1), opt_kw, False)
    with pytest.raises(ValueError, match="leaves"):
        train_detr.load_train_state(path, state, tx)
    state, tx = _port_state(port_detr.DETRConfig.tiny(num_classes=C8_C), dict(opt_kw, schedule="cosine",
                                                                            total_steps=9), False)
    with pytest.raises(ValueError, match="schedule"):
        train_detr.load_train_state(path, state, tx)


def test_jax_train_state_resumes_and_the_next_step_matches_jax(tmp_path):
    """The JAX trainer's state after one step (EMA on), saved as its trainer
    saves it, resumed in the port; then one more step on both sides."""
    from office_person_detection_vit_tpu.training import train_step as jax_step
    from tools.train_detr import _save_pytree

    from office_person_detection_vit_torch.training import train_step as port_step

    opt_kw = dict(learning_rate=1e-3, backbone_lr=1e-4)
    jmodel, jtx, jstate, pcfg = _jax_state(opt_kw, True, randomize=False, seed=2, enc_objectness=True)
    jstep = jax_step.make_train_step(jmodel, jtx, ema_decay=0.9)
    jb1, jb2 = ({k: jnp.asarray(v) for k, v in _c8_batch(s).items()} for s in (3, 4))
    jstate, _ = jstep(jstate, jb1, jax.random.PRNGKey(0))
    path = tmp_path / "train_state.npz"
    _save_pytree(path, jax.device_get(jstate))

    state, tx = _port_state(pcfg, opt_kw, True)
    train_detr.load_train_state(path, state, tx)
    assert state.step == 1 and state.opt_state.count == 1
    jstate2, jmet = jstep(jstate, jb2, jax.random.PRNGKey(1))
    step = port_step.make_train_step(state.model, tx, ema_decay=0.9)
    state, met = step(state, {k: torch.from_numpy(v) for k, v in _c8_batch(4).items()}, torch.Generator())
    assert state.step == 2 and state.opt_state.count == 2
    for key in met:
        np.testing.assert_allclose(met[key].item(), float(jmet[key]), rtol=1e-4, err_msg=key)
    # The update itself: Adam moves each leaf by about the learning rate, so
    # the parameters after the step agree to a small part of it (a leaf whose
    # gradient is rounding noise on both sides, see test_torch_train_step,
    # may move by up to twice the rate in either direction).
    got = _port_leaves(state, state.params)
    for key, a, b in zip(state.keys, got, jax.tree_util.tree_leaves(jstate2.params)):
        lr = opt_kw["backbone_lr" if key.startswith("backbone.") else "learning_rate"]
        assert np.abs(a - np.asarray(b)).max() <= 2.5 * lr, key
