"""Online detection server with micro-batching, on the card.

The port's counterpart of the repo's ``tools/serve.py``: a stdlib HTTP
server around a batched detector, whose :class:`MicroBatcher` coalesces
concurrent requests into one device batch of up to ``detection.batch_size``
frames. Every bucket size is run once at start-up, so no request waits for
cuDNN's algorithm choice or the kernel build.

Endpoints:
  POST /detect        image bytes (JPEG/PNG) -> {"detections": [...], "latency_ms"}
  GET  /healthz       liveness and model info
  GET  /stats         request, batch and frame counters (and the attention
                      kernels' launches, where they ran)

Run it as

    python -m office_person_detection_vit_torch.serve [--port 8500] [--host 127.0.0.1]
        [--config config.yaml | --tiny | --artifact program.pt2 --weights weights.npz [--confidence 0.5]]

The detector is ``detection/__init__.py::build_detector`` of the config (the
card unless ``detection.device`` asks for the CPU), or, with ``--artifact``,
an exported program and a path-keyed weights npz
(``detection/export.py::ExportedDetector``) with no model built. ``--tiny``
and ``--artifact`` have no config and run on the card (they raise where
there is none); a CPU server takes a ``--config`` with
``detection.device: cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

logger = logging.getLogger("serve")


class MicroBatcher:
    """Coalesce concurrent detect requests into device-sized batches."""

    def __init__(self, detector, max_batch: int, max_wait_ms: float = 5.0):
        self.detector = detector
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1000.0
        self.queue: queue.Queue = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "frames": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, frame: np.ndarray) -> list:
        """Blocking: the detections of one frame."""
        done = threading.Event()
        slot: dict = {}
        self.queue.put((frame, slot, done))
        done.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["detections"]

    def _loop(self) -> None:
        while True:
            frame, slot, done = self.queue.get()
            batch = [(frame, slot, done)]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < self.max_batch:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    batch.append(self.queue.get(timeout=timeout))
                except queue.Empty:
                    break
            # One batch per frame size: frames of different sizes cannot be
            # stacked, and each size is its own program.
            by_shape: dict[tuple, list] = {}
            for item in batch:
                by_shape.setdefault(item[0].shape, []).append(item)
            for group in by_shape.values():
                try:
                    frames = np.stack([g[0] for g in group])
                    results = self.detector.detect_batch(frames).to_frame_results()
                    for (_, slot_i, done_i), fr in zip(group, results):
                        slot_i["detections"] = [d.to_dict() for d in fr.detections]
                        done_i.set()
                    self.stats["requests"] += len(group)
                    self.stats["batches"] += 1
                    self.stats["frames"] += len(group)
                except Exception as e:  # the requests get the error; the loop goes on
                    logger.exception("batch failed")
                    for _, slot_i, done_i in group:
                        slot_i["error"] = str(e)
                        done_i.set()


def kernel_stats() -> dict:
    """The attention kernels' launches in this process, once their module is
    loaded (a detector on the card, or an exported program), so a client can
    see that the served program ran the hand-written kernels."""
    module = sys.modules.get(f"{__package__}.kernels.attention")
    return {} if module is None else {"attention_launches": dict(module.launch_counts)}


def make_handler(batcher: MicroBatcher, model_info: dict):
    import cv2

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            logger.debug(fmt, *args)

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", **model_info})
            elif self.path == "/stats":
                self._json(200, {**batcher.stats, **kernel_stats()})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/detect":
                self._json(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
            if img is None:
                self._json(400, {"error": "could not decode image"})
                return
            t0 = time.perf_counter()
            try:
                dets = batcher.submit(img)
            except RuntimeError as e:
                self._json(500, {"error": str(e)})
                return
            self._json(200, {"detections": dets, "latency_ms": round((time.perf_counter() - t0) * 1000, 2)})

    return Handler


def build(args: argparse.Namespace):
    """-> (detector warmed on every bucket size, model name)."""
    if args.artifact:
        from .detection.export import ExportedDetector

        detector = ExportedDetector(args.artifact, args.weights, confidence_threshold=args.confidence)
        h, w = detector.source_hw
        name = f"exported:{Path(args.artifact).name}"
    else:
        from .config.config_manager import ConfigManager
        from .detection import build_detector

        if args.config:
            cfg = ConfigManager(args.config)
        else:
            det = {"confidence_threshold": 0.5, "batch_size": 8, "device": "auto"}
            if args.tiny:
                det.update(model_size="tiny", input_height=96, input_width=128, dtype="float32",
                           use_pallas_attention=False)
            cfg = ConfigManager.from_dict({"detection": det})
        detector = build_detector(cfg)
        detector.load_model()
        h, w = 720, 1280
        name = str(cfg.get("detection.model", "detr"))
    buckets = detector._bucket_sizes() if hasattr(detector, "_bucket_sizes") else [detector.batch_size]
    for b in buckets:
        detector.detect_batch(np.zeros((b, h, w, 3), np.uint8))
        logger.info("warmed bucket %d", b)
    return detector, name


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="online detection server (PyTorch/CUDA port)")
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--config", default=None)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--artifact", type=Path, default=None,
                        help="serve an exported program (detection/export.py); requires --weights")
    parser.add_argument("--weights", type=Path, default=None, help="path-keyed weights npz for --artifact")
    parser.add_argument("--confidence", type=float, default=0.5, help="confidence threshold for --artifact")
    args = parser.parse_args(argv)
    if args.artifact and not args.weights:
        parser.error("--artifact requires --weights")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    detector, name = build(args)
    logger.info("model warm; serving on %s:%d", args.host, args.port)
    batcher = MicroBatcher(detector, max_batch=detector.batch_size)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(batcher, {"model": name, "batch_size": detector.batch_size}))
    print(f"serving on http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
