"""The port's ViT backbone (``models/vit.py``) and the ViT DETR against the
JAX package on the same weights and inputs, on the CPU (float32; attention
is the plain version here).

- ``ViTBackbone`` at the tiny tier (head dim 16) and at a narrow head-dim-64
  config (hidden 128, 2 heads, 2 layers), at a non-native grid: atol 1e-4,
  rtol 1e-4 (float32 summation order through two blocks, as
  tests/test_vit_backbone.py holds the JAX module against HF torch);
- the position-grid resize against ``jax.image.resize(..., "bicubic")``
  from the native 14 x 14 to ViT-base/16's 46 x 80 at 736x1280: 2e-6;
- the HF-key converter against the JAX ``convert_vit_state_dict`` on a
  config-built ``transformers.ViTModel`` (exactly), and the converted port
  backbone against HF torch at the native grid (1e-4);
- ``DETR(backbone="vit")`` logits and boxes at the DETR bar (logits atol
  2e-3 / rtol 1e-3, boxes 1e-3, tests/test_detr_parity.py);
- the detector's ViT config and ``feature_stride`` against the JAX
  detector's, a tiny ViT detect and attention map;
- one training step of a tiny ViT DETR: losses within 1e-4 relative, every
  gradient within 1e-4 of its leaf's max |grad| (tests/test_torch_train_step.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.detection.detector import DETRDetector
from office_person_detection_vit_torch.models import detr as port_detr
from office_person_detection_vit_torch.models import vit as port_vit
from office_person_detection_vit_torch.models import weights as port_weights
from office_person_detection_vit_torch.training import criterion as port_crit
from office_person_detection_vit_torch.training import train_step as port_step
from office_person_detection_vit_tpu.models import detr as jax_detr
from office_person_detection_vit_tpu.models import vit as jax_vit
from office_person_detection_vit_tpu.models.weights import convert_vit_state_dict as jax_convert
from office_person_detection_vit_tpu.training import criterion as jax_crit
from office_person_detection_vit_tpu.training import train_step as jax_step
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

#: The tiny ViT of the detector's small tiers (head dim 16), and a narrow
#: config with ViT-base's head dim 64.
VIT_CONFIGS = {
    "tiny_d16": dict(patch_size=8, hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128, pos_grid=4),
    "narrow_d64": dict(patch_size=8, hidden_size=128, num_layers=2, num_heads=2, mlp_dim=256, pos_grid=4),
}
TINY_VIT = dict(backbone="vit", vit_patch_size=8, vit_hidden=64, vit_layers=2, vit_heads=4, vit_mlp=128,
                vit_pos_grid=4)


def _port_config(jcfg, cls):
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})


@pytest.mark.parametrize("name", list(VIT_CONFIGS))
@pytest.mark.parametrize("hw", [(32, 32), (48, 80)], ids=["native_grid", "grid_6x10"])
def test_backbone_matches_jax(name, hw):
    jcfg = jax_vit.ViTConfig(**VIT_CONFIGS[name])
    rng = np.random.default_rng(0)
    img = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    jmodel = jax_vit.ViTBackbone(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(img)))

    pcfg = _port_config(jcfg, port_vit.ViTConfig)
    model = port_vit.ViTBackbone(pcfg).eval()
    model.load_state_dict(port_weights.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables), pcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    assert got.shape == (2, hw[0] // 8, hw[1] // 8, pcfg.hidden_size) == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_backbone_refuses_a_size_off_the_patch_grid():
    model = port_vit.ViTBackbone(port_vit.ViTConfig.tiny())
    with pytest.raises(ValueError, match="multiple of patch"):
        model(torch.zeros(1, 36, 32, 3))


@pytest.mark.parametrize("hw", [(46, 80), (6, 10), (14, 14)], ids=["vit_base_736x1280", "small", "native"])
def test_position_grid_resize_matches_jax_bicubic(hw):
    grid = np.random.default_rng(1).normal(size=(1, 14, 14, 8)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(grid), (1, *hw, 8), "bicubic"))
    got = port_vit.resize_position_grid(torch.from_numpy(grid), hw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


def _hf_vit():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.ViTConfig(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
                                 num_attention_heads=4, intermediate_size=128, hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    return transformers.ViTModel(cfg, add_pooling_layer=False).eval()


def test_hf_converter_matches_jax_and_hf():
    hf = _hf_vit()
    got = port_weights.convert_vit_state_dict(hf.state_dict(), num_layers=2)
    want = jax_convert(hf.state_dict(), num_layers=2)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b)), path

    cfg = port_vit.ViTConfig.tiny()
    model = port_vit.ViTBackbone(cfg).eval()
    model.load_state_dict(port_weights.state_dict_from_flax(got, cfg))
    img = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        want_feat = hf(pixel_values=torch.from_numpy(img).permute(0, 3, 1, 2)).last_hidden_state[:, 1:]
        feat = model(torch.from_numpy(img))
    np.testing.assert_allclose(feat.reshape(2, 16, 64).numpy(), want_feat.numpy(), atol=1e-4, rtol=1e-4)


def _jax_vit_detr(hw, **kw):
    jcfg = jax_detr.DETRConfig.tiny(num_classes=5, **TINY_VIT, **kw)
    jmodel, variables = jax_detr.init_detr(jcfg, jax.random.PRNGKey(0), input_hw=hw)
    pcfg = _port_config(jcfg, port_detr.DETRConfig)
    model = port_detr.DETR(pcfg)
    model.load_state_dict(port_weights.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables), pcfg))
    return jmodel, variables, model


def test_vit_detr_matches_jax():
    H, W = 48, 80
    jmodel, variables, model = _jax_vit_detr((H, W))
    assert isinstance(model.backbone, port_vit.ViTBackbone)
    rng = np.random.default_rng(0)
    img = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    mask = np.ones((2, H, W), bool)
    mask[1, :, 60:] = False  # a letterboxed image: the mask comes down to the patch grid
    want = jmodel.apply(variables, jnp.asarray(img), jnp.asarray(mask))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(img), torch.from_numpy(mask))
    assert got["feature_hw"] == tuple(want["feature_hw"]) == (6, 10)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), atol=1e-3)
    np.testing.assert_allclose(got["encoder_output"].numpy(), np.asarray(want["encoder_output"]),
                               atol=2e-3, rtol=1e-3)


def test_vit_weights_round_trip_through_the_flat_npz(tmp_path):
    cfg = port_detr.DETRConfig.tiny(**TINY_VIT)
    model = port_detr.DETR(cfg)
    model.init_weights(torch.Generator().manual_seed(3))
    path = tmp_path / "weights.npz"
    port_weights.save_flat_npz(path, model.state_dict(), cfg)
    sd = port_weights.load_checkpoint(path, cfg)
    assert set(sd) == set(model.state_dict())
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    assert float(model.backbone.cls_token.detach().std()) < 0.05  # N(0, 0.02), as the Flax init


@pytest.mark.parametrize("size", ["full", "tiny"])
def test_detector_vit_config_and_stride_match_jax(size):
    from office_person_detection_vit_tpu.detection.detector import DETRDetector as JaxDetector

    cfg = {"detection.backbone": "vit", "detection.model_size": size, "detection.device": "cpu"}
    port, ref = DETRDetector(cfg), JaxDetector(cfg)
    want = _port_config(ref.detr_config, port_detr.DETRConfig)
    assert port.detr_config == want and port.detr_config.backbone == "vit"
    assert port.feature_stride == ref.feature_stride == want.vit_patch_size
    if size == "full":
        assert (want.vit_hidden, want.vit_layers, want.vit_heads, want.vit_patch_size) == (768, 12, 12, 16)


def test_tiny_vit_detector_detects_and_maps_attention():
    det = DETRDetector({"detection.backbone": "vit", "detection.model_size": "tiny", "detection.device": "cpu",
                        "detection.input_height": 64, "detection.input_width": 96, "detection.batch_size": 2,
                        "detection.confidence_threshold": 0.0})
    assert det.feature_stride == 8 and det.feature_hw == (8, 12)
    frames = np.random.default_rng(0).integers(0, 256, (3, 72, 128, 3), np.uint8)
    batch = det.detect_batch(frames)
    assert batch.boxes_xywh.shape == (3, 10, 4) and np.isfinite(batch.boxes_xywh).all()
    assert det.last_failed_chunks == 0
    amap = det.get_attention_map(frames[0])
    assert amap.shape == (8, 12) and np.isfinite(amap).all()


def test_vit_detr_train_step_matches_jax():
    H, W, B, T, C = 48, 64, 2, 3, 5
    jmodel, variables, model = _jax_vit_detr((H, W))
    rng = np.random.default_rng(11)
    mask = np.ones((B, H, W), bool)
    mask[1, :, 40:] = False
    batch = {
        "pixels": rng.normal(size=(B, H, W, 3)).astype(np.float32),
        "pixel_mask": mask,
        "labels": rng.integers(0, C, (B, T)).astype(np.int32),
        "boxes": np.concatenate([rng.uniform(0.2, 0.8, (B, T, 2)), rng.uniform(0.05, 0.3, (B, T, 2))],
                                -1).astype(np.float32),
        "valid": np.array([[True, True, False], [True, False, False]]),
    }
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(params):
        return jax_step._loss_fn(params, jmodel, jax_crit.CriterionConfig(num_classes=C), jb["pixels"],
                                 jb["pixel_mask"], jb["labels"], jb["boxes"], jb["valid"], jax.random.PRNGKey(0),
                                 True)

    (_, jmet), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    model.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, met = port_step.loss_fn(model, port_crit.CriterionConfig(num_classes=C), tb, None, True)
    total.backward()
    for key in met:
        np.testing.assert_allclose(met[key].item(), float(jmet[key]), rtol=1e-4, err_msg=key)
    keys, params = port_step.ordered_parameters(model)
    got = port_weights.flat_leaves_from_state_dict(dict(zip(keys, port_step.gradients(params))), model.config)
    wants = [np.asarray(w) for w in jax.tree_util.tree_leaves(jgrads)]
    top = max(float(np.abs(w).max()) for w in wants)
    first = "decoder.layer_0.self_attn."
    n_backbone = 0
    for key, g, want in zip(keys, got, wants):
        if key.endswith("k_proj.bias") or key.startswith((first + "q_proj.", first + "k_proj.",
                                                          first + "v_proj.weight")):
            # Exactly zero on both sides but for rounding noise (see
            # tests/test_torch_train_step.py): the softmax cancels a key bias,
            # and the first decoder self-attention reads tgt = 0.
            assert max(np.abs(g).max(), np.abs(want).max()) <= 1e-4 * top, key
            continue
        n_backbone += key.startswith("backbone.")
        assert np.abs(g - want).max() <= 1e-4 * float(np.abs(want).max()), key
    assert n_backbone >= 20  # the ViT's own leaves are held too
