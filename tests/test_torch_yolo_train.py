"""The single-shot trainers of the port (ROADMAP A.7c) against the JAX
package, on the CPU, in float32, with seeded numpy inputs and the weights
carried across by ``models/weights.py``:

- ``assign_targets``, ``ciou``, ``dfl_loss``, ``ssd_loss`` and ``yolo_loss``
  on the same raw outputs and targets, to 1e-5;
- one tiny YOLO and one tiny single-shot train step with the DETR recipe's
  optimizer (clip, AdamW) and the EMA: the loss metrics, and every parameter
  and EMA leaf after the update, to 1e-5;
- ``train_detr --model yolo --tiny`` (the port) against
  ``tools/train_detr.py --model yolo --tiny`` (JAX), two steps each in a
  child process from the same initial weights: ``history.json``'s losses;
  its ``weights.npz`` loads into the port's YOLO detector;
- ``main --fine-tune`` with ``training.model: yolo`` trains.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.models import single_shot as port_ss
from office_person_detection_vit_torch.models import yolo as port_yolo
from office_person_detection_vit_torch.models.weights import flat_leaves_from_state_dict, state_dict_from_flax
from office_person_detection_vit_torch.training import ssd_criterion as port_ssd
from office_person_detection_vit_torch.training import train_step as port_step
from office_person_detection_vit_torch.training import yolo_criterion as port_yc
from office_person_detection_vit_tpu.models import single_shot as jax_ss
from office_person_detection_vit_tpu.models import yolo as jax_yolo
from office_person_detection_vit_tpu.training import ssd_criterion as jax_ssd
from office_person_detection_vit_tpu.training import train_step as jax_step
from office_person_detection_vit_tpu.training import yolo_criterion as jax_yc
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

REPO = Path(__file__).resolve().parent.parent
HW = (64, 96)
CONTENT = (54, 96)  # a letterboxed frame's valid rows
TOL = 1e-5


def _targets(rng, B=2, T=4):
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, T, 2)), rng.uniform(0.05, 0.6, (B, T, 2))], -1)
    valid = np.array([[True, True, True, False], [True, True, False, False]])[:B]
    labels = np.ones((B, T), np.int32)
    return labels, boxes.astype(np.float32), valid


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max(initial=0.0) <= tol * max(1.0, np.abs(want).max(initial=0.0))


@pytest.mark.parametrize("stride, size_range, content", [(8, (0.0, 64.0), None), (16, (64.0, 128.0), CONTENT),
                                                         (32, (128.0, float("inf")), CONTENT)])
def test_assign_targets_matches_jax(stride, size_range, content):
    _, boxes, valid = _targets(np.random.default_rng(stride))
    grid = (HW[0] // stride, HW[1] // stride)
    for b in range(2):
        want = jax_ssd.assign_targets(jnp.asarray(boxes[b]), jnp.asarray(valid[b]), grid, HW, 1.5, stride,
                                      size_range, content)
        got = port_ssd.assign_targets(torch.from_numpy(boxes[b]), torch.from_numpy(valid[b]), grid, HW, 1.5,
                                      stride, size_range, content)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy()[got[0].numpy()], np.asarray(want[1])[np.asarray(want[0])])


def test_ciou_and_dfl_loss_match_jax():
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 50, (64, 2, 2))
    wh = rng.uniform(1, 40, (64, 2, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)  # (64, 2, 4) xyxy pairs
    _close(port_yc.ciou(torch.from_numpy(boxes[:, 0]), torch.from_numpy(boxes[:, 1])).numpy(),
           jax_yc.ciou(jnp.asarray(boxes[:, 0]), jnp.asarray(boxes[:, 1])))
    dist = rng.normal(size=(10, 4, 16)).astype(np.float32)
    target = rng.uniform(0, 15 - 0.01, (10, 4)).astype(np.float32)
    _close(port_yc.dfl_loss(torch.from_numpy(dist), torch.from_numpy(target)).numpy(),
           jax_yc.dfl_loss(jnp.asarray(dist), jnp.asarray(target)))


def _levels(rng, kind: str, B=2, C=1, R=16):
    levels = []
    for s in (8, 16, 32):
        fh, fw = HW[0] // s, HW[1] // s
        if kind == "yolo":
            levels.append({"box_dist": rng.normal(size=(B, fh, fw, 4 * R)), "class_logits": rng.normal(size=(B, fh, fw, C))})
        else:
            levels.append({"objectness": rng.normal(size=(B, fh, fw)), "class_logits": rng.normal(size=(B, fh, fw, C)),
                           "ltrb": rng.uniform(0.1, 4.0, (B, fh, fw, 4))})
    return [{k: v.astype(np.float32) for k, v in lv.items()} for lv in levels]


@pytest.mark.parametrize("kind, content", [("yolo", CONTENT), ("ssd", None)])
def test_losses_match_jax(kind, content):
    rng = np.random.default_rng(7)
    levels = _levels(rng, kind)
    labels, boxes, valid = _targets(rng)
    jfn, pfn = (jax_yc.yolo_loss, port_yc.yolo_loss) if kind == "yolo" else (jax_ssd.ssd_loss, port_ssd.ssd_loss)
    jcfg = jax_yc.YOLOCriterionConfig() if kind == "yolo" else jax_ssd.SSDCriterionConfig()
    pcfg = port_yc.YOLOCriterionConfig() if kind == "yolo" else port_ssd.SSDCriterionConfig()
    _, want = jfn({"levels": [{k: jnp.asarray(v) for k, v in lv.items()} for lv in levels]}, jnp.asarray(labels),
                  jnp.asarray(boxes), jnp.asarray(valid), HW, jcfg, content)
    _, got = pfn({"levels": [{k: torch.from_numpy(v) for k, v in lv.items()} for lv in levels]},
                 torch.from_numpy(labels), torch.from_numpy(boxes), torch.from_numpy(valid), HW, pcfg, content)
    assert set(got) == set(want) and float(want["num_pos"]) >= 3
    for k in want:
        _close(got[k].item(), float(want[k]))


STEP_FAMILIES = {
    "yolo": (jax_yolo.init_yolo, jax_yolo.YOLOConfig.tiny(), port_yolo.YOLOConfig.tiny(), port_yolo.YOLOv8,
             jax_yc.make_yolo_train_step, port_yc.make_yolo_train_step),
    "ssd": (jax_ss.init_single_shot, jax_ss.SingleShotConfig.tiny(), port_ss.SingleShotConfig.tiny(),
            port_ss.SingleShotDetector, jax_ssd.make_ssd_train_step, port_ssd.make_ssd_train_step),
}


@pytest.mark.parametrize("kind", list(STEP_FAMILIES))
def test_train_step_matches_jax(kind):
    """One step with the DETR recipe's optimizer (lr 1e-4, clip 0.1, AdamW)
    and the EMA: the metrics, then every parameter and EMA leaf, to 1e-5 of
    max(1, |leaf|)."""
    init, jcfg, pcfg, port_cls, jmake, pmake = STEP_FAMILIES[kind]
    module, variables = init(jcfg, jax.random.PRNGKey(9), input_hw=(64, 64))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = port_cls(pcfg)
    model.load_state_dict(state_dict_from_flax(variables, pcfg))
    rng = np.random.default_rng(21)
    labels, boxes, valid = _targets(rng)
    pixels = rng.normal(size=(2, *HW, 3)).astype(np.float32)

    tx = jax_step.make_optimizer(learning_rate=1e-4)
    jstate = jax_step.TrainState.create(variables["params"], tx, ema=True)
    jbatch = {"pixels": jnp.asarray(pixels), "labels": jnp.asarray(labels), "boxes": jnp.asarray(boxes),
              "valid": jnp.asarray(valid)}
    jstate, jm = jmake(module, tx, HW, ema_decay=0.9, content_hw=CONTENT)(jstate, jbatch, jax.random.PRNGKey(0))

    ptx = port_step.make_optimizer(learning_rate=1e-4)
    pstate = port_step.TrainState.create(model, ptx, ema=True)
    pbatch = {"pixels": torch.from_numpy(pixels), "labels": torch.from_numpy(labels),
              "boxes": torch.from_numpy(boxes), "valid": torch.from_numpy(valid)}
    pstate, pm = pmake(model, ptx, HW, ema_decay=0.9, content_hw=CONTENT)(pstate, pbatch, torch.Generator())
    for k in jm:
        _close(pm[k].item(), float(jm[k]))
    for name, jtree, ptensors in (("params", jstate.params, pstate.params), ("ema", jstate.ema_params,
                                                                            pstate.ema_params)):
        want = jax.tree_util.tree_leaves(jtree)
        got = flat_leaves_from_state_dict(dict(zip(pstate.keys, ptensors)), pcfg)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    before = jax.tree_util.tree_leaves(variables["params"])
    after = flat_leaves_from_state_dict(dict(zip(pstate.keys, pstate.params)), pcfg)
    assert sum(not np.array_equal(a, b) for a, b in zip(after, before)) > len(before) // 2


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("recipe")
    subprocess.run([sys.executable, str(REPO / "tools" / "gen_recipe_dataset.py"), "--out", str(out),
                    "--train", "4", "--val", "0"], check=True, capture_output=True)
    return out / "train"


def test_train_detr_yolo_matches_the_jax_trainer(dataset, tmp_path):
    """Both trainers, ``--model yolo --tiny``, one epoch of two steps from the
    same initial weights (JAX's seeded init, as the JAX trainer's flat
    ``weights.npz``), each in a child process: the same ``history.json``
    losses to 1e-5, and weights the port's YOLO detector loads."""
    _, variables = jax_yolo.init_yolo(jax_yolo.YOLOConfig.tiny(), jax.random.PRNGKey(0), input_hw=(64, 64))
    init = tmp_path / "init.npz"
    np.savez(init, **{f"leaf_{i}": np.asarray(a) for i, a in enumerate(jax.tree_util.tree_leaves(
        {"params": variables["params"]}))})
    common = ["--images", str(dataset / "images"), "--annotations", str(dataset / "coco.json"), "--model", "yolo",
              "--tiny", "--batch", "2", "--height", "64", "--width", "128", "--max-targets", "4", "--epochs", "1",
              "--init", str(init)]
    env = {**__import__("os").environ, "JAX_PLATFORMS": "cpu"}
    runs = {"jax": [str(REPO / "tools" / "train_detr.py"), "--platform", "cpu"],
            "port": ["-m", "office_person_detection_vit_torch.train_detr", "--device", "cpu"]}
    losses = {}
    for name, head in runs.items():
        proc = subprocess.run([sys.executable, *head, *common, "--checkpoint", str(tmp_path / name)], cwd=REPO,
                              env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        losses[name] = json.loads((tmp_path / name / "history.json").read_text())["step_losses"]
    assert len(losses["port"]) == 2
    _close(losses["port"], losses["jax"])

    from office_person_detection_vit_torch.detection.yolo_detector import YOLODetector

    det = YOLODetector({"detection.device": "cpu", "detection.model_size": "tiny", "detection.input_height": 64,
                        "detection.input_width": 128, "detection.checkpoint_path": str(tmp_path / "port" / "weights.npz")})
    det.load_model()
    assert det.detect_batch(np.zeros((2, 72, 128, 3), np.uint8)).boxes_xywh.shape == (2, 10, 4)
