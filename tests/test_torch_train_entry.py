"""The port's training entry points on the CPU.

- ``python -m office_person_detection_vit_torch.train_detr --model-size tiny
  --device cpu`` trains one epoch on a small synthetic COCO set
  (``tools/gen_recipe_dataset.py``), writes ``weights.npz``, ``history.json``
  and a train state, and resumes from it;
- that ``weights.npz`` loads into the port's ``DETRDetector`` and into the
  JAX package's ``load_any_checkpoint``; the two models give the same logits
  and boxes within the DETR bar (logits atol 2e-3 / rtol 1e-3, boxes 1e-3);
- the flags the port refuses raise, naming their ROADMAP item;
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
    "yolo": (["--model", "yolo"], "A.7"),
    "vit": (["--backbone", "vit"], "A.7"),
    "model_parallel": (["--model-parallel", "2"], "A.8"),
    "evaluate": (["--evaluate"], "A.3"),
    "eval_every": (["--eval-every", "2"], "A.3"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_flags_name_their_roadmap_item(tmp_path, case):
    flags, item = REFUSED[case]
    argv = ["--images", str(tmp_path), "--annotations", str(tmp_path / "none.json"), *flags]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        train_detr.main(argv)


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
    cfg = _fine_tune_config(tmp_path / "c.yaml", dataset, tmp_path / "out")
    assert port_main_module.main(["--config", str(cfg), "--fine-tune"]) == 0
    assert (tmp_path / "out" / "weights.npz").stat().st_size > 0
    cfg = _fine_tune_config(tmp_path / "y.yaml", dataset, tmp_path / "y", model="yolo")
    assert port_main_module.main(["--config", str(cfg), "--fine-tune"]) == 2
    assert "ROADMAP A.7" in capsys.readouterr().out
    assert not (tmp_path / "y").exists()
