"""Port weight loading against the JAX package.

- the flat ``leaf_i`` order the port rebuilds equals ``jax.tree_util``'s
  flattening of the JAX template;
- the committed DETR-small checkpoint gives the same outputs through the port
  and through JAX at 224x384 (bar of tests/test_detr_parity.py: logits atol
  2e-3 / rtol 1e-3, boxes atol 1e-3);
- ``load_path_npz`` reads what JAX ``save_weights_npz`` writes, bf16 included;
- ``state_dict_from_hf`` agrees with JAX ``convert_torch_state_dict`` for both
  backbone namings (exactly: the same float32 arithmetic).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.models import detr as port_detr
from office_person_detection_vit_torch.models import weights as port_w
from office_person_detection_vit_tpu.detection.export import save_weights_npz
from office_person_detection_vit_tpu.models import detr as jax_detr
from office_person_detection_vit_tpu.models.weights import convert_torch_state_dict, load_any_checkpoint
from office_person_detection_vit_tpu.ops.preprocessing import preprocess_frames
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

WEIGHTS = Path(__file__).resolve().parent.parent / "docs" / "artifacts" / "detr_small_weights.npz"


def _jax_template(cfg, hw=(64, 64)):
    return jax.eval_shape(
        jax_detr.DETR(cfg).init, jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)), jnp.ones((1, *hw), bool)
    )


@pytest.mark.parametrize(
    "tier,kw",
    [
        ("small", dict(score_mode="sigmoid")),
        ("tiny", dict(num_encoder_layers=11, num_decoder_layers=3, dilate_c5=True)),  # layer_10 < layer_2
        ("tiny", dict(enc_objectness=True, class_prior=0.01)),
    ],
)
def test_flat_leaf_order_matches_jax_flattening(tier, kw):
    leaves = jax.tree_util.tree_flatten_with_path(_jax_template(getattr(jax_detr.DETRConfig, tier)(**kw)))[0]
    entries = port_w.flax_param_map(getattr(port_detr.DETRConfig, tier)(**kw))
    assert [tuple(k.key for k in path) for path, _ in leaves] == [e.flax_path for e in entries]
    assert [tuple(leaf.shape) for _, leaf in leaves] == [e.flax_shape for e in entries]


def test_committed_small_checkpoint_matches_jax():
    jcfg = jax_detr.DETRConfig.small(score_mode="sigmoid")
    jmodel, template = jax_detr.init_detr(jcfg, jax.random.PRNGKey(0), input_hw=(64, 64))
    variables = load_any_checkpoint(WEIGHTS, template=template)
    pcfg = port_detr.DETRConfig.small(score_mode="sigmoid")
    model = port_detr.DETR(pcfg)
    model.load_state_dict(port_w.load_checkpoint(WEIGHTS, pcfg))
    model.eval()

    frames = np.random.default_rng(0).integers(0, 256, (2, 720, 1280, 3), np.uint8)
    pixels, mask = preprocess_frames(jnp.asarray(frames), target_hw=(224, 384))
    want = jmodel.apply(variables, pixels, mask)
    with torch.no_grad():
        got = model(torch.from_numpy(np.array(pixels)), torch.from_numpy(np.array(mask)))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), atol=1e-3)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_path_npz_round_trip(tmp_path, dtype):
    cfg = jax_detr.DETRConfig.tiny(num_classes=3)
    _, variables = jax_detr.init_detr(cfg, jax.random.PRNGKey(1), input_hw=(64, 64))
    variables = jax.tree_util.tree_map(lambda a: a.astype(dtype), variables)
    path = tmp_path / "w.npz"
    n = save_weights_npz(variables, path)
    loaded = port_w.load_path_npz(path)
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    assert len(want) == n
    for keypath, leaf in want:
        node = loaded
        for k in keypath:
            node = node[k.key]
        assert node.dtype == np.float32
        np.testing.assert_array_equal(node, np.asarray(leaf.astype(jnp.float32)))
    # The chain the detector uses: a path-keyed file -> port state_dict.
    sd = port_w.load_checkpoint(path, port_detr.DETRConfig.tiny(num_classes=3))
    ref = port_w.state_dict_from_flax(jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)), variables),
                                      port_detr.DETRConfig.tiny(num_classes=3))
    assert sd.keys() == ref.keys()
    for key in sd:
        torch.testing.assert_close(sd[key], ref[key], rtol=0, atol=0)


def _hf_state_dict(cfg: port_detr.DETRConfig, timm: bool, seed: int) -> dict:
    """A HF DetrForObjectDetection-named state_dict of random tensors."""
    rng = np.random.default_rng(seed)
    hf = "model.backbone.conv_encoder.model"
    sd = {}

    def put(key, shape):
        sd[key] = torch.from_numpy(rng.normal(0, 0.2, shape).astype(np.float32))

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[f"{prefix}.bias"] = torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32))
        sd[f"{prefix}.running_mean"] = torch.from_numpy(rng.uniform(-0.5, 0.5, c).astype(np.float32))
        sd[f"{prefix}.running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))

    for e in port_w.flax_param_map(cfg):
        path, leaf = e.flax_path[1:-1], e.flax_path[-1]
        if e.kind == "conv":
            kh, kw, ci, co = e.flax_shape
            shape = (co, ci, kh, kw)
        elif e.kind == "dense":
            shape = e.flax_shape[::-1]
        else:
            shape = e.flax_shape
        if path and path[0] == "backbone":
            if leaf == "bias":
                continue  # written with its BN's scale
            blk, name = path[1], path[-1]
            if blk.startswith("embedder"):
                base = f"{hf}.conv1" if timm else f"{hf}.embedder.embedder"
                bn_prefix = f"{hf}.bn1" if timm else f"{base}.normalization"
                conv_key = f"{base}.weight" if timm else f"{base}.convolution.weight"
            else:
                s, l = (int(x) for x in blk[len("stage"):].split("_layer"))
                short = name.startswith("shortcut")
                j = None if short else int(name[-1])
                if timm:
                    blk_p = f"{hf}.layer{s + 1}.{l}"
                    conv_key = f"{blk_p}.downsample.0.weight" if short else f"{blk_p}.conv{j + 1}.weight"
                    bn_prefix = f"{blk_p}.downsample.1" if short else f"{blk_p}.bn{j + 1}"
                else:
                    sub = f"{hf}.encoder.stages.{s}.layers.{l}." + ("shortcut" if short else f"layer.{j}")
                    conv_key, bn_prefix = f"{sub}.convolution.weight", f"{sub}.normalization"
            if e.kind == "conv":
                put(conv_key, shape)
            else:
                bn(bn_prefix, shape[0])
            continue
        suffix = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf] if path else "weight"
        if not path:  # query_position_embeddings
            put("model.query_position_embeddings.weight", shape)
            continue
        if path[0] in ("encoder", "decoder"):
            rest = ".".join(path[1:]) if path[1] == "layernorm" else f"layers.{path[1][len('layer_'):]}." + ".".join(path[2:])
            rest = rest.rstrip(".")
            put(f"model.{path[0]}.{rest}.{suffix}".replace("..", "."), shape)
        elif path[0] == "input_projection":
            put(f"model.input_projection.{suffix}", shape)
        elif path[0] == "bbox_predictor":
            put(f"bbox_predictor.layers.{path[1][-1]}.{suffix}", shape)
        else:
            put(f"{path[0]}.{suffix}", shape)
    return sd


@pytest.mark.parametrize("timm", [False, True])
def test_state_dict_from_hf_matches_jax_converter(tmp_path, timm):
    cfg = port_detr.DETRConfig.tiny(num_classes=4)
    sd = _hf_state_dict(cfg, timm, seed=2)
    got = port_w.state_dict_from_hf(sd, cfg)
    want = port_w.state_dict_from_flax(convert_torch_state_dict(sd, 2, 2), cfg)
    assert got.keys() == want.keys()
    for key in got:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    path = tmp_path / "hf.pt"
    torch.save(sd, path)
    loaded = port_w.load_checkpoint(path, cfg)
    for key in got:
        torch.testing.assert_close(loaded[key], got[key], rtol=0, atol=0)
    port_detr.DETR(cfg).load_state_dict(got)


def test_flat_npz_rejects_a_mismatched_config():
    with pytest.raises(ValueError, match="leaves"):
        port_w.load_flat_npz(WEIGHTS, port_detr.DETRConfig.tiny())
