"""Export and serving of the port (ROADMAP A.8) on the CPU.

- ``serve.MicroBatcher`` and the HTTP handler as ``tests/test_serve.py``
  holds the JAX server's: a ``/detect`` round trip, ``/healthz``, a bad image
  answered 400, concurrent requests coalesced into fewer device batches;
- ``detection/export.py``: the tiny DETR (float32, the JAX detector's
  weights) exported with a symbolic batch and reloaded from the file, against
  the live ``detect_batch`` and against the JAX package's ``run_exported``
  of the JAX detector's own export on the same weights (scores to 1e-5, boxes
  at the DETR bar, 1e-3 px); the path-keyed weights npz the port writes is
  the one JAX writes (same keys, values to 1e-7); the attention in the
  program is the port's operator;
- ``serve.py --artifact`` end to end: concurrent JPEG posts answered with the
  exported detector's detections of the decoded frames, coalesced.
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import cv2
import jax
import numpy as np
import pytest

from office_person_detection_vit_torch.core.dto import Detection, detections_to_batch
from office_person_detection_vit_torch.detection import export as port_export
from office_person_detection_vit_torch.detection.detector import DETRDetector
from office_person_detection_vit_torch.models.detr import DETRConfig
from office_person_detection_vit_torch.serve import MicroBatcher, make_handler
from office_person_detection_vit_tpu.config.config_manager import ConfigManager
from office_person_detection_vit_tpu.detection import export as jax_export
from office_person_detection_vit_tpu.detection.detector import DETRDetector as JaxDETRDetector
from office_person_detection_vit_tpu.models.detr import DETRConfig as JaxDETRConfig
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

HW = (96, 128)
DETECTION = {"confidence_threshold": 0.0, "batch_size": 2, "input_height": HW[0], "input_width": HW[1],
             "dtype": "float32", "use_pallas_attention": False}


class FakeDetector:
    """Counts its batches; one fixed detection a frame."""

    batch_size = 4

    def __init__(self):
        self.calls = []

    def detect_batch(self, frames):
        self.calls.append(frames.shape[0])
        return detections_to_batch([[Detection(bbox=(1, 2, 3, 4), confidence=0.9)] for _ in frames], capacity=2)


def serve(detector, max_wait_ms: float = 1.0):
    batcher = MicroBatcher(detector, max_batch=detector.batch_size, max_wait_ms=max_wait_ms)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(batcher, {"model": "fake"}))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, batcher, f"http://127.0.0.1:{srv.server_address[1]}"


def post(url: str, img: np.ndarray) -> dict:
    ok, buf = cv2.imencode(".png", img)
    with urllib.request.urlopen(urllib.request.Request(f"{url}/detect", data=buf.tobytes(), method="POST")) as r:
        return json.loads(r.read())


def post_concurrently(url: str, frames) -> list:
    out = [None] * len(frames)

    def call(i):
        out[i] = post(url, frames[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_http_endpoints_round_trip_and_coalesce():
    det = FakeDetector()
    srv, batcher, url = serve(det, max_wait_ms=50)
    try:
        with urllib.request.urlopen(f"{url}/healthz") as r:
            assert json.loads(r.read()) == {"status": "ok", "model": "fake"}
        doc = post(url, np.zeros((60, 80, 3), np.uint8))
        assert len(doc["detections"]) == 1 and doc["detections"][0]["bbox"]["width"] == 3 and "latency_ms" in doc
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(urllib.request.Request(f"{url}/detect", data=b"not an image", method="POST"))
        assert exc.value.code == 400
        docs = post_concurrently(url, [np.zeros((8, 8, 3), np.uint8)] * 6)
        assert all(len(d["detections"]) == 1 for d in docs)
        with urllib.request.urlopen(f"{url}/stats") as r:
            stats = json.loads(r.read())
        assert stats["requests"] == stats["frames"] == 7 and stats["batches"] < 7  # coalesced
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The JAX tiny DETR and its export; the port's detector on its weights,
    its export written and read back; the port's path-keyed weights."""
    d = tmp_path_factory.mktemp("export")
    jdet = JaxDETRDetector(ConfigManager.from_dict({"detection": DETECTION, "parallel": {"mesh": {"data": 1}}}),
                           detr_config=JaxDETRConfig.tiny(num_classes=5))
    jdet.load_model()
    jax_export.save_weights_npz(jdet.variables, d / "jax_w.npz")
    det = DETRDetector({f"detection.{k}": v for k, v in DETECTION.items()} | {"detection.device": "cpu",
                                                                            "detection.checkpoint_path": str(d / "jax_w.npz")},
                       detr_config=DETRConfig.tiny(num_classes=5))
    det.load_model()
    program = port_export.export_detect(det, source_hw=HW)
    size = port_export.save_exported(program, d / "detr.pt2")
    port_export.save_weights_npz(det, d / "w.npz")
    return jdet, det, d, size


def test_exported_detr_matches_live_and_jax(exported):
    jdet, det, d, size = exported
    assert 0 < size < 4 * 2**20
    loaded = port_export.load_exported(d / "detr.pt2")
    assert len(loaded.state_dict) == 0  # the weights are an input, not state the artifact carries
    ops = {str(n.target) for n in loaded.graph.nodes if n.op == "call_function"}
    assert "office_person_detection_vit_torch.attention.default" in ops
    assert not any("scaled_dot_product" in o for o in ops)
    got_w, want_w = port_export.load_weights_npz(d / "w.npz"), jax_export.load_weights_npz(d / "jax_w.npz")
    flat = lambda t, p=(): sum((flat(v, p + (k,)) for k, v in t.items()), []) if isinstance(t, dict) else [(p, t)]  # noqa: E731
    assert [p for p, _ in flat(got_w)] == [p for p, _ in flat(want_w)]
    for (_, a), (_, b) in zip(flat(got_w), flat(want_w)):
        np.testing.assert_allclose(a, b, atol=1e-7)

    frames = np.random.default_rng(3).integers(0, 256, (3, *HW, 3), np.uint8)
    params = port_export.program_params(got_w, loaded._detect_meta, "cpu")
    got = port_export.run_exported(loaded, params, frames, orig_wh=(HW[1], HW[0]), conf=0.0)
    live = det.detect_batch(frames)
    jprog = jax_export.export_detect(jdet, source_hw=HW, platforms=None)
    want = jax_export.run_exported(jprog, jax_export.load_weights_npz(d / "w.npz"), frames,
                                   orig_wh=(HW[1], HW[0]), conf=0.0)
    for ref in (live.__dict__, want):
        np.testing.assert_array_equal(got["valid"], np.asarray(ref["valid"]))
        np.testing.assert_allclose(got["scores"], np.asarray(ref["scores"]), atol=1e-5)
        np.testing.assert_allclose(got["boxes_xywh"], np.asarray(ref["boxes_xywh"]), atol=1e-3)
        np.testing.assert_allclose(got["foot"], np.asarray(ref["foot"]), atol=1e-3)


def test_serve_artifact_answers_concurrent_posts(exported):
    _, det, d, _ = exported
    served = port_export.ExportedDetector(d / "detr.pt2", d / "w.npz", confidence_threshold=0.3, batch_size=4,
                                          device="cpu")
    assert served.source_hw == HW and served._bucket_sizes() == [1, 2, 4]
    srv, batcher, url = serve(served, max_wait_ms=100)
    try:
        frames = [np.random.default_rng(10 + i).integers(0, 256, (120, 160, 3), np.uint8) for i in range(4)]
        docs = post_concurrently(url, frames)
        assert batcher.stats["requests"] == 4 and batcher.stats["batches"] < 4
    finally:
        srv.shutdown()
        srv.server_close()
    det.confidence_threshold = 0.3
    for frame, doc in zip(frames, docs):
        want = served.detect_batch(frame[None]).to_frame_results()[0].detections
        assert len(doc["detections"]) == len(want)
        for g, w in zip(doc["detections"], want):
            assert abs(g["confidence"] - w.confidence) <= 1e-5
            assert abs(g["bbox"]["x"] - w.bbox[0]) <= 1e-3 and abs(g["bbox"]["height"] - w.bbox[3]) <= 1e-3
