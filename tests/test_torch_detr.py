"""Port DETR forward against the JAX DETR on the same weights and inputs.

The JAX variables come from ``init_detr`` and reach the port through
``state_dict_from_flax``; images and masks are numpy from a seed. float32 on
the CPU, where the port's attention is the plain version. Bar, as
tests/test_detr_parity.py holds the JAX model against HF torch: logits atol
2e-3 / rtol 1e-3, boxes atol 1e-3; the same for the encoder output and the
objectness logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.models import detr as port_detr
from office_person_detection_vit_torch.models.position_encoding import sine_position_embedding
from office_person_detection_vit_torch.models.weights import state_dict_from_flax
from office_person_detection_vit_tpu.models import detr as jax_detr
from office_person_detection_vit_tpu.models.position_encoding import (
    sine_position_embedding as jax_sine,
)
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)


CASES = {
    "tiny": dict(tier="tiny", kw=dict(num_classes=5), hw=(96, 128)),
    "tiny_dc5": dict(tier="tiny", kw=dict(num_classes=5, dilate_c5=True), hw=(96, 128)),
    "small_prior_ragged": dict(
        tier="small", kw=dict(num_classes=3, class_prior=0.01, score_mode="sigmoid"), hw=(128, 160)
    ),
}


def port_model_from_jax(jax_cfg, variables, **port_kw):
    """Port DETR carrying the JAX variables (numpy) -> eval-mode module."""
    fields = {f.name for f in dataclasses.fields(port_detr.DETRConfig)}
    cfg = port_detr.DETRConfig(**{k: v for k, v in dataclasses.asdict(jax_cfg).items() if k in fields}, **port_kw)
    model = port_detr.DETR(cfg)
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables), cfg))
    return model.eval()


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(name):
    case = CASES[name]
    jcfg = getattr(jax_detr.DETRConfig, case["tier"])(**case["kw"])
    H, W = case["hw"]
    jmodel, variables = jax_detr.init_detr(jcfg, jax.random.PRNGKey(0), input_hw=(H, W))
    model = port_model_from_jax(jcfg, variables)

    rng = np.random.default_rng(0)
    img = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    mask = np.ones((2, H, W), bool)
    if name.endswith("ragged"):
        mask[1, :, 100:] = False
        mask[1, 90:, :] = False
    want = jmodel.apply(variables, jnp.asarray(img), jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(mask))

    assert got["feature_hw"] == tuple(want["feature_hw"])
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), atol=1e-3)
    np.testing.assert_allclose(
        got["encoder_output"].numpy(), np.asarray(want["encoder_output"]), atol=2e-3, rtol=1e-3
    )
    if jcfg.enc_objectness:
        np.testing.assert_allclose(
            got["enc_obj_logits"].numpy(), np.asarray(want["enc_obj_logits"]), atol=2e-3, rtol=1e-3
        )
        np.testing.assert_array_equal(got["feature_mask"].numpy(), np.asarray(want["feature_mask"]))


def test_sine_position_embedding_matches_jax():
    mask = np.ones((2, 6, 9), bool)
    mask[1, 4:, :] = False
    mask[1, :, 7:] = False
    got = sine_position_embedding(torch.from_numpy(mask), embedding_dim=32).numpy()
    want = np.asarray(jax_sine(jnp.asarray(mask), embedding_dim=32))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_full_width_parameter_count():
    """DETRConfig() builds DETR-R50 at its published width: 41.6 M values,
    the frozen-BN scale/bias buffers included, as the JAX init counts them."""
    n = sum(t.numel() for t in port_detr.DETR(port_detr.DETRConfig()).state_dict().values())
    assert n == 41_577_888


def test_bfloat16_rounds_weights_once():
    model = port_detr.DETR(port_detr.DETRConfig.tiny(dtype="bfloat16"))
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(torch.bfloat16).eval()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        out = model(x)
    assert out["logits"].dtype == torch.float32 and out["boxes"].dtype == torch.float32
    assert out["encoder_output"].dtype == torch.bfloat16
    assert torch.isfinite(out["logits"]).all()
