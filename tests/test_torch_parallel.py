"""Scale-out of the port (ROADMAP A.8) on the CPU: ``parallel/`` against the
JAX package's rules and the port's own one-device steps.

- ``make_mesh``'s divisibility rules and its 1x1 degrade, as
  ``tests/test_parallel.py`` holds JAX's (one process: a grid of more ranks
  needs a process group of that size);
- the tensor-parallel specs of every parameter of a tiny DETR (ResNet and
  ViT backbones) are JAX's ``param_specs`` on the same Flax leaves, with the
  split dim moved by the kernel transpose;
- ``initialize_distributed`` skips a single-process environment and hands
  its arguments to ``init_process_group``;
- on 2 gloo ranks, data-parallel (2, 1) and tensor-parallel (1, 2): the
  sharded DETR step (dropout 0.1, augmentation, EMA) and the data-parallel
  YOLO step against the one-device step on the whole batch (loss to 1e-5
  relative, every parameter and EMA leaf to 1e-5 of max(1, |leaf|)), and
  ``make_sharded_detect`` against one forward (boxes at the DETR bar of
  1e-3 px, scores to 1e-5). Each spawns two
  processes (``parallel/selfcheck.py``, as ``torchrun`` would) with a
  timeout.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.models.detr import DETRConfig as PortDETRConfig
from office_person_detection_vit_torch.models.weights import flax_param_map
from office_person_detection_vit_torch.parallel import mesh as port_mesh
from office_person_detection_vit_torch.parallel.sharding import param_specs as port_specs
from office_person_detection_vit_tpu.parallel.sharding import param_specs as jax_specs

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n, mp, want", [(None, 1, (1, 1)), (1, 1, (1, 1)), (1, 3, "must divide"),
                                         (8, 3, "must divide"), (2, 1, "process group of 2")])
def test_make_mesh_rules(n, mp, want):
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            port_mesh.make_mesh(n, model_parallel=mp)
        return
    mesh = port_mesh.make_mesh(n, model_parallel=mp)
    assert mesh.shape == {port_mesh.DATA_AXIS: want[0], port_mesh.MODEL_AXIS: want[1]}
    assert (mesh.data_index, mesh.model_index, mesh.data_group().size) == (0, 0, 1)
    x = torch.arange(6)
    assert torch.equal(port_mesh.batch_sharding(mesh)(x), x) and port_mesh.replicated(mesh)(x) is x


@pytest.mark.parametrize("backbone", ["resnet50", "vit"])
def test_tensor_parallel_specs_are_jax_rules(backbone):
    extra = {} if backbone == "resnet50" else dict(backbone="vit", vit_hidden=64, vit_layers=2, vit_heads=2,
                                                   vit_mlp=128, vit_pos_grid=4, vit_patch_size=8)
    entries = flax_param_map(PortDETRConfig.tiny(**extra))
    tree: dict = {}
    for e in entries:
        node = tree
        for p in e.flax_path[:-1]:
            node = node.setdefault(p, {})
        node[e.flax_path[-1]] = np.zeros(e.flax_shape, np.float32)
    want = jax_specs(tree)
    got = port_specs([e.key for e in entries])
    split = 0
    for e in entries:
        node = want
        for p in e.flax_path:
            node = node[p]
        jspec = tuple(node) + (None,) * (len(e.flax_shape) - len(tuple(node)))
        if e.kind in ("conv", "dense"):
            jspec = jspec[::-1]  # Flax (in, out) -> torch (out, in)
        pspec = got[e.key] + (None,) * (len(e.flax_shape) - len(got[e.key]))
        assert pspec == jspec, e.key
        split += "model" in pspec
    assert split >= 4 * 2 * 3  # attention and FFN of every layer


@pytest.mark.parametrize("index", [0, 1])
def test_shard_params_takes_the_model_ranks_part(index):
    """``shard_params`` on model rank ``index`` of 2: each tensor a rule
    splits is its half along the rule's axis, every other tensor is whole."""
    from office_person_detection_vit_torch.models.detr import DETR
    from office_person_detection_vit_torch.parallel.sharding import shard_params

    model = DETR(PortDETRConfig.tiny())
    model.init_weights(torch.Generator().manual_seed(0))
    state = model.state_dict()
    mesh = port_mesh.Mesh(data_parallel=1, model_parallel=2, rank=index, data_group_handle=None, model_group=None)
    placed = shard_params(state, mesh)
    specs = port_specs(state)
    assert placed.keys() == state.keys()
    for key, t in state.items():
        dim = specs[key].index("model") if "model" in specs[key] else None
        want = t if dim is None else t.chunk(2, dim)[index]
        assert torch.equal(placed[key], want), key
    assert sum("model" in spec for spec in specs.values()) >= 4 * 2 * 3


def test_initialize_distributed_passthrough_and_single_process(monkeypatch):
    calls = []
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(port_mesh.dist, "init_process_group", lambda backend, **kw: calls.append((backend, kw)))
    port_mesh.initialize_distributed()  # a single-process environment: nothing to start
    assert calls == [] and port_mesh.world() == (0, 1)
    monkeypatch.setattr(port_mesh.dist, "get_rank", lambda: 2)
    monkeypatch.setattr(port_mesh.dist, "get_world_size", lambda: 4)
    port_mesh.initialize_distributed(coordinator_address="10.0.0.1:8476", num_processes=4, process_id=2)
    assert calls == [("gloo", dict(init_method="tcp://10.0.0.1:8476", world_size=4, rank=2))]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_sharded_steps_and_detect_match_one_device(tmp_path, mode):
    port = _free_port()
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "2"}
    procs = [subprocess.Popen([sys.executable, "-m", "office_person_detection_vit_torch.parallel.selfcheck", mode,
                               str(tmp_path), "cpu"], cwd=REPO, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs[0][-3000:] + logs[1][-3000:]
    for r in range(2):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["backend"] == "gloo" and res["all_reduce"] == 2.0
        assert res["shape"] == ({"data": 2, "model": 1} if mode == "dp" else {"data": 1, "model": 2})
        for model in ("detr", "yolo"):
            got = res[model]
            assert got["metrics"] and got["moved"], (model, got)
            assert got["loss"] <= 1e-5 and got["params"] <= 1e-5 and got["ema"] <= 1e-5, (model, got)
        det = res["detect"]  # pixels at the DETR bar (1e-3), scores to 1e-5, the same valid slots
        assert det["boxes_xywh"] <= 1e-3 and det["foot"] <= 1e-3 and det["scores"] <= 1e-5 and det["valid"] == 0, det
