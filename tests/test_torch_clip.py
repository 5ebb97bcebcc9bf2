"""The port's CLIP image tower and Re-ID ``model_type: clip`` against the JAX
package's, on the CPU in float32.

- A tiny random ``FlaxCLIPModel`` checkpoint (the config of JAX
  ``tests/test_feature_extractor.py``'s CLIP case: hidden 32, 2 layers of
  2 heads, patch 56, projection 24; the parameter shapes from
  ``jax.eval_shape`` of its init, the values seeded numpy, written as
  ``save_pretrained`` writes them), loaded by both extractors: the port
  reads ``flax_model.msgpack`` with its own decoder. Features within 2e-5
  (absolute, unit vectors; both compute float32 in another order), boxes
  at the frame's edges and an empty one included.
- The same weights in HF's torch layout (``model.safetensors`` with HF's
  key names and shapes, text tower and ``position_ids`` included) give the
  same state dict, exactly.
- A missing directory, a source that is not set and an unreadable
  checkpoint give crop histograms in both, with the JAX warning.
- ``read_flax_msgpack`` against ``flax.serialization.msgpack_restore`` on a
  tree of float32, bfloat16, int and scalar leaves: equal values.
"""

import logging

import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.models import weights as port_weights
from office_person_detection_vit_torch.models.clip import CLIPImageTower, CLIPVisionConfig
from office_person_detection_vit_torch.tracking.reid_feature_extractor import ReIDFeatureExtractor
from office_person_detection_vit_tpu.tracking.reid_feature_extractor import ReIDFeatureExtractor as JaxExtractor
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

FEATURE_ATOL = 2e-5
BOXES = [(10.0, 20.0, 60.0, 120.0), (200.0, 50.0, 80.0, 150.0), (290.0, 200.0, 60.0, 60.0),
         (-10.0, -5.0, 30.0, 30.0), (320.0, 10.0, 20.0, 20.0)]


@pytest.fixture(scope="module")
def flax_params():
    import jax
    from transformers import CLIPConfig, FlaxCLIPModel

    cfg = CLIPConfig(
        text_config={"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
                     "max_position_embeddings": 16, "vocab_size": 99},
        vision_config={"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
                       "image_size": 224, "patch_size": 56},
        projection_dim=24,
    )
    model = FlaxCLIPModel(cfg, _do_init=False)
    shapes = jax.eval_shape(lambda key: model.init_weights(key, model.input_shape), jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    return cfg, jax.tree_util.tree_map(lambda s: (0.1 * rng.normal(size=s.shape)).astype(s.dtype), shapes)


@pytest.fixture(scope="module")
def clip_dir(flax_params, tmp_path_factory):
    from flax import serialization

    cfg, params = flax_params
    path = tmp_path_factory.mktemp("clip") / "tiny-clip"
    cfg.save_pretrained(path)
    (path / "flax_model.msgpack").write_bytes(serialization.to_bytes(params))
    return path


def frame():
    return np.random.default_rng(0).integers(0, 255, (240, 320, 3), np.uint8)


def test_clip_features_match_jax(clip_dir):
    port = ReIDFeatureExtractor(model_type="clip", model_path=str(clip_dir), device="cpu")
    ref = JaxExtractor(model_type="clip", model_path=str(clip_dir))
    port.load_model()
    ref.load_model()
    assert (port.backend, port.feature_dim) == (ref.backend, ref.feature_dim) == ("clip", 24)
    got, want = port.extract_features(frame(), BOXES), ref.extract_features(frame(), BOXES)
    assert got.shape == (len(BOXES), 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert port.extract_features(frame(), []).shape == (0, 24)


def test_from_config_reads_the_source_and_the_device(clip_dir):
    ext = ReIDFeatureExtractor.from_config({"tracking.reid.model_type": "clip", "tracking.reid.model_name": str(clip_dir),
                                            "detection.device": "cpu"})
    ext.load_model()
    assert ext.backend == "clip" and ext.device == torch.device("cpu")
    assert next(ext._clip.parameters()).device.type == "cpu"


def hf_torch_state_dict(params) -> dict:
    """Flax CLIP params -> HF torch ``CLIPModel`` names and layouts."""
    from flax.traverse_util import flatten_dict

    sd = {}
    for path, v in flatten_dict(params).items():
        v = np.asarray(v)
        *head, leaf = path
        if leaf == "kernel":
            v, leaf = (v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T), "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        sd[".".join([*head, leaf])] = torch.from_numpy(np.ascontiguousarray(v))
    sd["vision_model.embeddings.position_ids"] = torch.arange(17)[None]
    return sd


def test_torch_layout_loads_the_same_tower(flax_params, clip_dir, tmp_path):
    from safetensors.torch import save_file

    (tmp_path / "pt").mkdir()
    (tmp_path / "pt" / "config.json").write_bytes((clip_dir / "config.json").read_bytes())
    save_file(hf_torch_state_dict(flax_params[1]), str(tmp_path / "pt" / "model.safetensors"))
    from_flax = port_weights.load_clip_tower(clip_dir).state_dict()
    from_pt = port_weights.load_clip_tower(tmp_path / "pt").state_dict()
    assert from_pt.keys() == from_flax.keys()
    for k, v in from_flax.items():
        torch.testing.assert_close(from_pt[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["missing_dir", "no_source", "unreadable"])
def test_clip_falls_back_to_histograms_as_jax(clip_dir, tmp_path, caplog, case):
    source = {"missing_dir": str(tmp_path / "nowhere"), "no_source": None, "unreadable": str(tmp_path / "bad")}[case]
    if case == "unreadable":
        (tmp_path / "bad").mkdir()
        (tmp_path / "bad" / "config.json").write_bytes((clip_dir / "config.json").read_bytes())
        (tmp_path / "bad" / "flax_model.msgpack").write_bytes((clip_dir / "flax_model.msgpack").read_bytes()[:4000])
    port = ReIDFeatureExtractor(model_type="clip", model_path=source, device="cpu")
    ref = JaxExtractor(model_type="clip", model_path=source)
    with caplog.at_level(logging.WARNING):
        port.load_model()
        ref.load_model()
    assert (port.backend, port.feature_dim) == (ref.backend, ref.feature_dim) == ("histogram", 256)
    assert sum("CLIP unavailable" in r.getMessage() for r in caplog.records) == 2
    np.testing.assert_array_equal(port.extract_features(frame(), BOXES[:3]), ref.extract_features(frame(), BOXES[:3]))


def test_read_flax_msgpack_matches_flax(tmp_path):
    import jax.numpy as jnp
    from flax import serialization

    rng = np.random.default_rng(2)
    tree = {"a": {"kernel": rng.normal(size=(3, 4)).astype(np.float32), "bias": np.arange(5, dtype=np.int32)},
            "b": jnp.asarray(rng.normal(size=(2, 3)), jnp.bfloat16), "scale": np.float32(2.5),
            "c": {"d": np.zeros((0, 2), np.float64), "e": rng.normal(size=(70000,)).astype(np.float32)}}
    (tmp_path / "t.msgpack").write_bytes(serialization.to_bytes(tree))
    got = port_weights.read_flax_msgpack(tmp_path / "t.msgpack")
    want = serialization.msgpack_restore((tmp_path / "t.msgpack").read_bytes())

    def check(g, w):
        if isinstance(w, dict):
            assert isinstance(g, dict) and set(g) == set(w)
            for k in w:
                check(g[k], w[k])
        else:
            w = np.asarray(w, np.float32) if str(np.asarray(w).dtype) == "bfloat16" else np.asarray(w)
            np.testing.assert_array_equal(np.asarray(g), w)
            assert np.asarray(g).shape == w.shape

    check(got, want)


def test_tower_at_published_widths_counts_its_attention_calls():
    """openai/clip-vit-base-patch32's widths on the meta device: 12 blocks of
    12 heads of 64 over 50 tokens, a 512-d projection, the parameter count
    of the published vision tower and projection (87,456,000 + 393,216)."""
    c = CLIPVisionConfig()
    with torch.device("meta"):
        tower = CLIPImageTower(c)
    assert c.num_positions == 50 and c.hidden_size // c.num_attention_heads == 64
    assert len(tower.vision_model.encoder.layers) == 12
    assert sum(p.numel() for p in tower.parameters()) == 87_456_000 + 768 * 512
