"""The single-shot detector families of the port (``models/yolo.py``,
``models/single_shot.py``, their weight maps and detectors) against the JAX
package, on the CPU at the tiny configs in float32.

The same seeded inputs go through Flax and the port on the same weights (the
Flax init carried over, an ultralytics-layout state_dict through both
converters, or the trainer's flat npz). Bars: raw head outputs within 1e-4;
``DetectionBatch`` boxes and foot points within 1e-3 px, scores within 1e-5,
valid flags equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from office_person_detection_vit_torch.detection import SSDDetector, YOLODetector, build_detector
from office_person_detection_vit_torch.detection.detector import DETRDetector
from office_person_detection_vit_torch.models import single_shot as port_ss
from office_person_detection_vit_torch.models import weights as port_weights
from office_person_detection_vit_torch.models import yolo as port_yolo
from office_person_detection_vit_tpu.config.config_manager import ConfigManager
from office_person_detection_vit_tpu.detection.ssd_detector import SSDDetector as JaxSSDDetector
from office_person_detection_vit_tpu.detection.yolo_detector import YOLODetector as JaxYOLODetector
from office_person_detection_vit_tpu.models import single_shot as jax_ss
from office_person_detection_vit_tpu.models import weights as jax_weights
from office_person_detection_vit_tpu.models import yolo as jax_yolo
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)
from tests.helpers.torch_yolov8 import DetectionModel, randomize_bn_stats

RAW_TOL, BOX_TOL, SCORE_TOL = 1e-4, 1e-3, 1e-5
HW = (96, 128)  # the model's input; frames are 120x160 (a 0.8x resize)

FAMILIES = {
    "yolo": (jax_yolo.init_yolo, jax_yolo.YOLOConfig.tiny(), port_yolo.YOLOConfig.tiny(), port_yolo.YOLOv8,
             jax_yolo.decode_yolo, port_yolo.decode_yolo),
    "ssd": (jax_ss.init_single_shot, jax_ss.SingleShotConfig.tiny(), port_ss.SingleShotConfig.tiny(),
            port_ss.SingleShotDetector, jax_ss.decode_single_shot, port_ss.decode_single_shot),
}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """Flax init -> port model; both forwards on one seeded input."""
    init, jcfg, pcfg, port_cls, jdecode, pdecode = FAMILIES[request.param]
    module, variables = init(jcfg, jax.random.PRNGKey(4), input_hw=(64, 64))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = port_cls(pcfg)
    model.load_state_dict(port_weights.state_dict_from_flax(variables, pcfg))
    x = np.random.default_rng(5).normal(size=(2, *HW, 3)).astype(np.float32)
    want = module.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    return request.param, want, got, (jcfg, pcfg, jdecode, pdecode), variables


def test_raw_outputs_match_flax(family):
    name, want, got, _, _ = family
    assert len(got["levels"]) == 3
    for lw, lg in zip(want["levels"], got["levels"]):
        assert lw.keys() == lg.keys()
        for key in lw:
            assert lg[key].dtype == torch.float32 and tuple(lg[key].shape) == lw[key].shape, (name, key)
            np.testing.assert_allclose(lg[key].numpy(), np.asarray(lw[key]), atol=RAW_TOL, err_msg=f"{name} {key}")
    np.testing.assert_allclose(got["features"].numpy(), np.asarray(want["features"]), atol=RAW_TOL)


@pytest.mark.parametrize("conf", ["zero", "median"])
def test_decode_matches_jax(family, conf):
    """At threshold 0 (NMS alone decides) and at the median of the kept
    candidates' scores (the threshold splits them)."""
    name, want, got, (jcfg, pcfg, jdecode, pdecode), _ = family
    if conf == "median":
        scores = np.asarray(jdecode(want, jnp.asarray([160.0, 120.0]), HW, jcfg, 0.0).scores)
        conf = float(np.median(scores[scores > 0]))
    else:
        conf = 0.0
    jb = jdecode(want, jnp.asarray([160.0, 120.0]), HW, jcfg, conf)
    pb = pdecode(got, (160, 120), HW, pcfg, conf)
    assert pb.boxes_xywh.shape == (2, pcfg.max_detections, 4)
    np.testing.assert_array_equal(pb.valid, np.asarray(jb.valid))
    np.testing.assert_allclose(pb.scores, np.asarray(jb.scores), atol=SCORE_TOL)
    np.testing.assert_allclose(pb.boxes_xywh, np.asarray(jb.boxes_xywh), atol=BOX_TOL)
    np.testing.assert_allclose(pb.foot, np.asarray(jb.foot), atol=BOX_TOL)
    assert pb.valid.any()


def test_dfl_expectation_matches_jax():
    logits = np.random.default_rng(6).normal(size=(2, 3, 5, 64)).astype(np.float32) * 3
    np.testing.assert_allclose(port_yolo.dfl_expectation(torch.from_numpy(logits), 16).numpy(),
                               np.asarray(jax_yolo.dfl_expectation(jnp.asarray(logits), 16)), atol=1e-5)


@pytest.mark.parametrize("variant", ["n", "s", "m", "l", "x", "tiny"])
def test_variant_widths_and_parameter_count_match_flax(variant):
    """Every variant's channel plan, and the whole Flax tree's leaf shapes
    (x: the 736x1280 detector this slice runs at full width)."""
    jcfg, pcfg = jax_yolo.YOLOConfig(variant=variant), port_yolo.YOLOConfig(variant=variant)
    assert [pcfg.width(c) for c in port_yolo._BASE_CH] == [jcfg.width(c) for c in jax_yolo._BASE_CH]
    shapes = jax.eval_shape(lambda: jax_yolo.YOLOv8(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    want = {tuple(str(k.key) for k in p): leaf.shape for p, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {e.flax_path: e.flax_shape for e in port_weights.flax_param_map(pcfg)}
    assert got == want


def _ultralytics(seed: int = 0) -> DetectionModel:
    tm = DetectionModel(jax_yolo.VARIANTS["tiny"], nc=1)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if "dfl" not in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    randomize_bn_stats(tm, seed + 1)
    return tm.eval()


@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "model_model"])
def test_ultralytics_pt_route_equals_jax_conversion(tmp_path, wrapped):
    """An ultralytics state_dict saved as ``.pt`` (bare keys, or under
    ``model.model.``) loads into the port's YOLOv8 as JAX's
    ``convert_yolov8_state_dict`` converts it, and the port's forward on it
    matches the ultralytics-layout torch model's (BN folded with eps 1e-3)."""
    tm = _ultralytics(3)
    sd = tm.state_dict()
    if wrapped:
        sd = {f"model.{k}": v for k, v in sd.items()}
    path = tmp_path / "best.pt"
    torch.save(sd, path)
    cfg = port_yolo.YOLOConfig.tiny()
    got = port_weights.load_checkpoint(path, cfg)
    want = port_weights.state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                     jax_weights.convert_yolov8_state_dict(sd)), cfg)
    assert got.keys() == want.keys()
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    model = port_yolo.YOLOv8(cfg)
    model.load_state_dict(got)
    x = np.random.default_rng(8).normal(size=(1, 64, 96, 3)).astype(np.float32) * 0.5
    with torch.no_grad():
        levels = model(torch.from_numpy(x))["levels"]
        ref = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for lv, (box, cls) in zip(levels, ref):
        np.testing.assert_allclose(lv["box_dist"].numpy(), box.numpy().transpose(0, 2, 3, 1), atol=2e-4)
        np.testing.assert_allclose(lv["class_logits"].numpy(), cls.numpy().transpose(0, 2, 3, 1), atol=2e-4)


DETECTION = {"confidence_threshold": 0.0, "batch_size": 2, "input_height": HW[0], "input_width": HW[1],
             "model_size": "tiny", "nms_threshold": 0.45}


@pytest.fixture(scope="module")
def detector_runs(tmp_path_factory):
    """Each facade through detect_batch on the CPU, JAX and port, on the
    trainer's flat npz (SSD, YOLO) and an ultralytics ``.pt`` (YOLO)."""
    tmp = tmp_path_factory.mktemp("ck")
    frames = np.random.default_rng(9).integers(0, 256, (5, 120, 160, 3), np.uint8)
    runs = {}
    for name, init, jcfg, jcls, pcls in (
            ("ssd", jax_ss.init_single_shot, jax_ss.SingleShotConfig.tiny(), JaxSSDDetector, SSDDetector),
            ("yolo", jax_yolo.init_yolo, jax_yolo.YOLOConfig.tiny(), JaxYOLODetector, YOLODetector)):
        _, variables = init(jcfg, jax.random.PRNGKey(7), input_hw=(64, 64))
        leaves = jax.tree_util.tree_leaves(jax.device_get(variables))
        path = tmp / f"{name}_weights.npz"
        np.savez(path, **{f"leaf_{i}": np.asarray(a) for i, a in enumerate(leaves)})
        runs[f"{name}_npz"] = path
    pt = tmp / "best.pt"
    torch.save(_ultralytics(11).state_dict(), pt)
    runs["yolo_pt"] = pt
    out = {}
    for key, path in runs.items():
        name = key.split("_")[0]
        cfg = dict(DETECTION, checkpoint_path=str(path), model=name)
        jcls, pcls = (JaxSSDDetector, SSDDetector) if name == "ssd" else (JaxYOLODetector, YOLODetector)
        jdet = jcls(ConfigManager.from_dict({"detection": cfg, "parallel": {"mesh": {"data": 1}}}))
        pdet = build_detector({f"detection.{k}": v for k, v in cfg.items()} | {"detection.device": "cpu"})
        assert type(pdet) is pcls
        out[key] = (jdet.detect_batch(frames), pdet.detect_batch(frames), pdet, frames)
    return out


@pytest.mark.parametrize("key", ["ssd_npz", "yolo_npz", "yolo_pt"])
def test_detectors_match_jax(detector_runs, key):
    want, got, det, _ = detector_runs[key]
    assert got.boxes_xywh.shape == (5, 10, 4) and det.last_failed_chunks == 0
    np.testing.assert_array_equal(got.valid, np.asarray(want.valid))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=SCORE_TOL)
    np.testing.assert_allclose(got.boxes_xywh, np.asarray(want.boxes_xywh), atol=BOX_TOL)
    np.testing.assert_allclose(got.foot, np.asarray(want.foot), atol=BOX_TOL)
    assert got.valid.any()


@pytest.mark.parametrize("key", ["ssd_npz", "yolo_npz"])
def test_detector_facade(detector_runs, key):
    """detect / detect_with_features (crop histograms) / extract_features /
    get_attention_map (None) / cleanup, on the loaded detector."""
    _, got, det, frames = detector_runs[key]
    dets = det.detect(frames[0])
    assert len(dets) == int(got.valid[0].sum())
    with_feats, feats = det.detect_with_features(frames[0])
    assert len(with_feats) == len(dets) and feats.shape[0] == len(dets)
    assert all(d.feature is not None for d in with_feats)
    np.testing.assert_array_equal(det.extract_features(frames[0], [d.bbox for d in dets]), feats)
    assert det.get_attention_map(frames[0]) is None
    assert not hasattr(det, "_pool_features") and not hasattr(det, "transfer_format")


@pytest.mark.parametrize("model,cls", [("ssd", SSDDetector), ("single_shot", SSDDetector), ("fcos", SSDDetector),
                                       ("yolo", YOLODetector), ("yolov8", YOLODetector), ("detr", DETRDetector)])
def test_build_detector_routes_like_jax(model, cls):
    assert type(build_detector({"detection.model": model})) is cls


def test_missing_checkpoint_warns_and_inits(tmp_path, caplog):
    det = YOLODetector({"detection.device": "cpu", "detection.model_size": "tiny",
                        "detection.checkpoint_path": str(tmp_path / "none.pt")})
    det.load_model()
    assert "not found; using random init" in caplog.text
    assert det.model_config == port_yolo.YOLOConfig.tiny(nms_iou_threshold=0.45)
    assert YOLODetector({"detection.yolo_variant": "s"}).model_config.variant == "s"
