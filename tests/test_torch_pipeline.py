"""The port's orchestrator, entry point and host services against the JAX
package's, on the CPU.

- The whole flow: one synthetic video (a timestamp burned in, two people
  moving), the committed DETR-small checkpoint through both loaders, the
  JAX ``PipelineOrchestrator`` in this process and the port's entry point
  ``python -m office_person_detection_vit_torch --config <yaml>`` in a child
  process (``detection.device: cpu``; it imports no JAX). The same
  ``extraction_results.csv`` and extracted frames; detections within the
  DETR bar; ``coordinate_transformations.json``'s floor points within 1e-3
  px of the JAX run's, and of the JAX transform of the port's own
  detections; Phase 2.5 (``tracking.enabled``, the cascade over the encoder
  features) with the same track ids, ``tracking_statistics.json`` and frame
  index, boxes in the track files within the DETR bar; the same
  ``zone_counts.csv``; ``summary.json``,
  ``pipeline_checkpoint.json`` and ``metadata.json`` with the same keys and
  statistics; the same session layout, floormap PNGs of the same size.
- Resume skips the same phases in both, and rewrites the same
  ``zone_counts.csv``.
- ``main``: a missing config returns 1; ``--timestamps-only`` returns 0 with
  the JAX ``main.py``'s frames; the ``i420`` upload and the tiny YOLOv8 run to
  ``summary.json``; each refusal returns 2 before any session directory
  exists.
- ``ConfigManager`` and the CLI; the services (session layout, checkpoint
  JSON, metadata, retention), the performance monitor and its trace, the
  memory and logging utilities; the floormap renders (pixel-equal) and the
  matplotlib charts (the same image size).
"""

import csv
import json
import os
import subprocess
import sys
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from office_person_detection_vit_torch.cli.arguments import parse_arguments
from office_person_detection_vit_torch.config.config_manager import ConfigManager, ConfigValidationError
from office_person_detection_vit_torch.core import dto as port_dto
from office_person_detection_vit_torch.detection.detector import TRANSFER_FORMATS
from office_person_detection_vit_torch.main import main as port_main
from office_person_detection_vit_torch.pipeline.orchestrator import PipelineOrchestrator
from office_person_detection_vit_torch.pipeline.phases import VisualizationPhase
from office_person_detection_vit_torch.services.checkpoint_service import CheckpointService
from office_person_detection_vit_torch.services.output_service import OutputService
from office_person_detection_vit_torch.utils import logging_utils, memory_utils
from office_person_detection_vit_torch.utils.output_manager import OutputManager
from office_person_detection_vit_torch.utils.performance_monitor import PerformanceMonitor
from office_person_detection_vit_torch.visualization.floormap_visualizer import FloormapVisualizer
from office_person_detection_vit_torch.visualization.visualizer import Visualizer
from office_person_detection_vit_tpu.cli.arguments import parse_arguments as jax_parse_arguments
from office_person_detection_vit_tpu.config import config_manager as jax_config
from office_person_detection_vit_tpu.core import dto as jax_dto
from office_person_detection_vit_tpu.pipeline.orchestrator import PipelineOrchestrator as JaxPipelineOrchestrator
from office_person_detection_vit_tpu.pipeline.phases.transform import TransformPhase as JaxTransformPhase
from office_person_detection_vit_tpu.pipeline.phases.visualization import VisualizationPhase as JaxVisualizationPhase
from office_person_detection_vit_tpu.services.checkpoint_service import CheckpointService as JaxCheckpointService
from office_person_detection_vit_tpu.services.output_service import OutputService as JaxOutputService
from office_person_detection_vit_tpu.utils import logging_utils as jax_logging_utils
from office_person_detection_vit_tpu.utils.output_manager import OutputManager as JaxOutputManager
from office_person_detection_vit_tpu.utils.performance_monitor import PerformanceMonitor as JaxPerformanceMonitor
from office_person_detection_vit_tpu.visualization.floormap_visualizer import FloormapVisualizer as JaxFloormapVisualizer
from office_person_detection_vit_tpu.visualization.visualizer import Visualizer as JaxVisualizer
from tests.helpers.synthetic_video import write_video
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)
from tests.test_torch_features import SMALL
from tests.test_torch_phases import DETECTION_PX_KEYS, DETECTION_PX_TOL, _assert_json_close
from tests.test_torch_timestamp import read_extraction_csv

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from main import main as jax_main  # noqa: E402 (the root main.py: the JAX package's entry)

T0 = datetime(2025, 1, 20, 9, 0, 0)
PX_TOL = 1e-3
#: camera -> floormap, a little perspective (as tests/test_torch_phases.py)
H = [[1.2, 0.1, 50.0], [0.05, 1.5, 60.0], [1e-5, 2e-4, 1.0]]
ZONES = [
    {"id": "zone_1", "name": "desks", "polygon": [[100, 100], [900, 100], [900, 800], [100, 800]], "priority": 2},
    {"id": "zone_2", "name": "meeting", "polygon": [[900, 100], [1700, 100], [1700, 1100], [900, 1100]],
     "priority": 1},
]
#: Keys of metadata.json's reproducibility block that name each package's
#: runtime: JAX's backend and devices, the port's torch/CUDA record.
RUNTIME_KEYS = {"jax": {"jax_backend", "jax_device_count", "jax_devices"},
                "port": {"torch_version", "cuda_version", "cuda_device_count", "cuda_devices"}}


def flow_config(out: Path, video: Path, **overrides) -> dict:
    cfg = {
        "video": {"input_path": str(video), "fps": 30, "frame_interval_minutes": 5, "tolerance_seconds": 60,
                  "time_compression_ratio": 313.0},
        "detection": dict(SMALL, batch_size=4),
        "parallel": {"mesh": {"data": 1}},
        "transform": {"method": "homography"},
        "homography": {"matrix": H},
        "zones": ZONES,
        "output": {"directory": str(out), "save_floormap_images": True},
        "tracking": {"enabled": True},
        "timestamp": {"extraction_mode": "auto_targets", "auto_targets": {"max_frames": 60, "disable_validation": True},
                      "sampling": {"coarse_interval_seconds": 0.5}, "extraction": {"confidence_threshold": 0.3}},
    }
    for dot, v in overrides.items():
        node = cfg
        *parents, leaf = dot.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return cfg


def write_config(path: Path, cfg: dict) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return path


def sessions(out: Path) -> list[Path]:
    """Session directories under an output directory (not ``latest``)."""
    return sorted(p for p in out.iterdir() if p.is_dir() and not p.is_symlink()) if out.exists() else []


def start_port_entry(*argv: str) -> subprocess.Popen:
    """``python -m office_person_detection_vit_torch`` in a child process,
    with 2 torch threads."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(REPO))
    return subprocess.Popen([sys.executable, "-m", "office_person_detection_vit_torch", *argv], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(proc: subprocess.Popen) -> str:
    """The child's output, once it has exited 0."""
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out[-6000:]
    return out


def stop(proc: subprocess.Popen) -> None:
    """End the child if it still runs (a failed check above left it)."""
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def snapshot(session: Path) -> dict:
    """Every file of a session: JSON parsed, CSV as rows, other files' bytes."""
    out = {}
    for p in sorted(session.rglob("*")):
        if p.is_file() and p.name != "system.log":
            rel = str(p.relative_to(session))
            if p.suffix == ".json":
                out[rel] = json.loads(p.read_text())
            elif p.suffix == ".csv":
                out[rel] = p.read_text()
            else:
                out[rel] = p.read_bytes()
    return out


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    # 70 frames at 30 fps, ratio 313: 09:00:00 to 09:12:10 (three targets), two people walking
    return write_video(tmp_path_factory.mktemp("video") / "flow.mp4", num_frames=70,
                       people_fn=lambda i: [(200 + 3 * i, 250, 1), (800 - 2 * i, 380, 2)])


@pytest.fixture(scope="module")
def flow(video, tmp_path_factory):
    """Both pipelines over the video: the JAX orchestrator here, the port's
    entry point in a child process; each session's files as they were."""
    tmp = tmp_path_factory.mktemp("flow")
    cfg_path = write_config(tmp / "port.yaml", flow_config(tmp / "port", video))
    proc = start_port_entry("--config", str(cfg_path))  # runs beside the JAX run
    jax_cfg = jax_config.ConfigManager.from_dict(flow_config(tmp / "jax", video))
    try:
        JaxPipelineOrchestrator(jax_cfg).run()
        stdout = finish(proc)
    finally:
        stop(proc)
    (jsession,), (psession,) = sessions(tmp / "jax"), sessions(tmp / "port")
    return {"jax": snapshot(jsession), "port": snapshot(psession), "jax_session": jsession, "port_session": psession,
            "jax_cfg": jax_cfg, "port_cfg": cfg_path, "stdout": stdout}


# ---------------------------------------------------------------- the flow
def test_flow_entry_point_runs_on_the_cpu_without_jax(flow):
    assert "Phase 06_visualization" in flow["stdout"]
    assert flow["port"]["summary.json"]["status"] == "completed"


def test_flow_extraction_matches_jax(flow):
    rows = {k: read_extraction_csv(flow[f"{k}_session"] / "01_extraction" / "extraction_results.csv")
            for k in ("jax", "port")}
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 4  # 09:00 .. 09:10
    frames = sorted(k for k in flow["jax"] if k.startswith("01_extraction/frames/"))
    assert frames == sorted(k for k in flow["port"] if k.startswith("01_extraction/frames/")) and len(frames) == 3
    for k in frames:
        assert flow["port"][k] == flow["jax"][k]


def test_flow_detections_match_jax(flow):
    for name in ("detections.json", "detection_statistics.json"):
        got, want = flow["port"][f"02_detection/{name}"], flow["jax"][f"02_detection/{name}"]
        if name == "detection_statistics.json":  # the port has only the BGR transfer
            got, want = dict(got, transfer_format=None), dict(want, transfer_format=None)
        _assert_json_close(got, want, 1e-3, name, DETECTION_PX_KEYS)
    assert flow["port"]["02_detection/detection_statistics.json"]["total_detections"] >= 4


def test_flow_transform_matches_jax(flow):
    """Floor points within 1e-3 px of the JAX run's (millimetres within that
    times the floormap's 28.24 mm a pixel), boxes within the DETR bar; and
    each floor point within 1e-3 px of the JAX transform of the port's own
    detection."""
    got = flow["port"]["04_transform/coordinate_transformations.json"]
    _assert_json_close(got, flow["jax"]["04_transform/coordinate_transformations.json"], 1e-3, "transform",
                       dict(DETECTION_PX_KEYS, floor_coords_px=PX_TOL, floor_coords_mm=PX_TOL * 28.25))
    results = [jax_dto.FrameResult(f["frame_number"], f["timestamp"], [
        jax_dto.Detection(bbox=tuple(d["bbox"][k] for k in ("x", "y", "width", "height")), confidence=d["confidence"])
        for d in f["detections"]]) for f in flow["port"]["02_detection/detections.json"]["frames"]]
    JaxTransformPhase(flow["jax_cfg"]).execute(results)
    for fdoc, fr in zip(got["frames"], results):
        assert len(fdoc["detections"]) == len(fr.detections)
        for d, want in zip(fdoc["detections"], fr.detections):
            assert [d["floor_coords_px"]["x"], d["floor_coords_px"]["y"]] == pytest.approx(want.floor_coords_px,
                                                                                             abs=PX_TOL)
            assert d.get("zone_ids", []) == want.zone_ids


def _track_rows(text: str, header: bool) -> list:
    """A track CSV's rows: the ids and timestamps as text, boxes and
    confidences as numbers."""
    rows = list(csv.reader(text.splitlines()))[1 if header else 0:]
    return [[float(v) if i in ((3, 4, 5, 6, 7) if header else (2, 3, 4, 5, 6)) else v for i, v in enumerate(r)]
            for r in rows]


def test_flow_tracking_matches_jax(flow):
    """Phase 2.5 over the encoder features of the same detections: the same
    track ids on the same frames, statistics and frame index; boxes within
    the DETR bar (and one unit of their rounding), confidences within 1e-3."""
    got = {k[len("03_tracking/"):]: v for k, v in flow["port"].items() if k.startswith("03_tracking/")}
    want = {k[len("03_tracking/"):]: v for k, v in flow["jax"].items() if k.startswith("03_tracking/")}
    assert set(got) == set(want) == {"tracks.csv", "tracks_mot.csv", "tracks.json", "frames_index.csv",
                                     "tracking_statistics.json"}
    assert got["tracking_statistics.json"] == want["tracking_statistics.json"]
    assert got["tracking_statistics.json"]["unique_tracks"] >= 2 and got["frames_index.csv"] == want["frames_index.csv"]
    for name, header, tol in (("tracks.csv", True, 0.1), ("tracks_mot.csv", False, 0.01)):
        g, w = _track_rows(got[name], header), _track_rows(want[name], header)
        assert len(g) == len(w) >= 4, name
        for gr, wr in zip(g, w):
            assert [v for v in gr if isinstance(v, str)] == [v for v in wr if isinstance(v, str)], name
            nums = [(a, b) for a, b in zip(gr, wr) if isinstance(a, float)]
            assert all(abs(a - b) <= DETECTION_PX_TOL + tol for a, b in nums[:4]), (name, gr, wr)
            assert abs(nums[4][0] - nums[4][1]) <= 2e-3, (name, gr, wr)
    _assert_json_close(got["tracks.json"], want["tracks.json"], 2e-3, "tracks.json",
                       {"bbox": DETECTION_PX_TOL + 0.1})


def test_flow_zone_counts_match_jax(flow):
    text = flow["port"]["05_aggregation/zone_counts.csv"]
    assert text == flow["jax"]["05_aggregation/zone_counts.csv"]
    rows = list(csv.reader(text.splitlines()))
    assert rows[0] == ["timestamp", "zone_1", "zone_2", "unclassified", "total"] and len(rows) == 4
    assert sum(int(r[-1]) for r in rows[1:]) >= 4


def test_flow_summary_and_checkpoints_match_jax(flow):
    got, want = flow["port"]["summary.json"], flow["jax"]["summary.json"]
    assert got.keys() == want.keys() and got["statistics"] == want["statistics"]
    assert got["performance"].keys() == want["performance"].keys()
    assert set(got["performance"]) == {"01_extraction", "02_detection", "03_tracking", "04_transform",
                                       "05_aggregation", "06_visualization"}
    got, want = flow["port"]["pipeline_checkpoint.json"], flow["jax"]["pipeline_checkpoint.json"]
    assert got.keys() == want.keys() and got["last_phase"] == want["last_phase"] == "06_visualization"
    assert got["phases"].keys() == want["phases"].keys()
    for phase, entry in want["phases"].items():
        assert got["phases"][phase]["status"] == entry["status"]
        data = dict(got["phases"][phase]["data"]), dict(entry["data"])
        if phase == "02_detection":
            for d in data:
                d.pop("transfer_format")
        _assert_json_close(*data, 1e-3)
    assert got["phases"]["03_tracking"]["status"] == "completed"
    assert got["phases"]["03_tracking"]["data"] == want["phases"]["03_tracking"]["data"]


def test_flow_metadata_and_layout_match_jax(flow):
    got, want = flow["port"]["metadata.json"], flow["jax"]["metadata.json"]
    assert got.keys() == want.keys()
    assert set(got["reproducibility"]) - RUNTIME_KEYS["port"] == set(want["reproducibility"]) - RUNTIME_KEYS["jax"]
    assert RUNTIME_KEYS["port"] <= set(got["reproducibility"])
    assert got["reproducibility"]["torch_version"] == torch.__version__
    assert got["config"]["zones"] == want["config"]["zones"]
    assert set(flow["port"]) == set(flow["jax"])
    assert len([k for k in flow["port"] if k.startswith("06_visualization/floormaps/")]) == 3
    for k in flow["port"]:
        if k.endswith(".png"):
            import cv2

            shapes = [cv2.imdecode(np.frombuffer(flow[n][k], np.uint8), cv2.IMREAD_COLOR).shape for n in ("port", "jax")]
            assert shapes[0] == shapes[1], k


def test_resume_skips_the_same_phases_as_jax(flow):
    """Resuming a finished session reloads phases 1-4 (01 to 04) and
    visualization, and reruns only the aggregation (its results live in
    memory), in both packages; the rewritten zone_counts.csv is the same."""
    proc = start_port_entry("--config", str(flow["port_cfg"]), "--resume", str(flow["port_session"]))
    jax_orch = JaxPipelineOrchestrator(flow["jax_cfg"])
    try:
        jax_orch.run(resume_session=flow["jax_session"])
        finish(proc)
    finally:
        stop(proc)
    summary = json.loads((flow["port_session"] / "summary.json").read_text())
    assert set(summary["performance"]) == set(jax_orch.perf.summary()) == {"05_aggregation"}
    assert summary["statistics"] == flow["port"]["summary.json"]["statistics"]
    text = (flow["port_session"] / "05_aggregation" / "zone_counts.csv").read_text()
    assert text == flow["port"]["05_aggregation/zone_counts.csv"]
    assert text == (flow["jax_session"] / "05_aggregation" / "zone_counts.csv").read_text()


def test_resume_with_evaluate_scores_like_jax(flow, tmp_path):
    """``--evaluate`` after the pipeline (here a resumed session): the frames'
    detections joined to a COCO ground-truth file by the saved frame's name,
    ``evaluation/evaluation_metrics.{json,csv}`` written, in both entry
    points. The ground truth is the JAX run's detections of two of the three
    frames, so the counts are exact on both sides."""
    import main as root_main

    session = flow["jax_session"]
    with (session / "01_extraction" / "extraction_results.csv").open() as f:
        paths = {int(r["frame_number"]): r["frame_path"] for r in csv.DictReader(f) if r.get("frame_path")}
    frames = json.loads((session / "02_detection" / "detections.json").read_bytes())["frames"]
    images, annotations = [], []
    for i, fr in enumerate(frames[:2]):
        images.append({"id": i, "file_name": Path(paths[fr["frame_number"]]).name, "width": 1280, "height": 720})
        for d in fr["detections"]:
            b = d["bbox"]
            annotations.append({"id": len(annotations), "image_id": i, "bbox": [b["x"], b["y"], b["width"], b["height"]],
                                "category_id": 1})
    gt = tmp_path / "gt.json"
    gt.write_text(json.dumps({"images": images, "annotations": annotations}))
    got = {}
    for name, entry in (("port", port_main), ("jax", root_main.main)):
        doc = yaml.safe_load(flow["port_cfg"].read_text())
        doc["evaluation"] = {"ground_truth_path": str(gt), "iou_threshold": 0.5}
        cfg = write_config(tmp_path / f"{name}.yaml", doc)
        assert entry(["--config", str(cfg), "--resume", str(flow[f"{name}_session"]), "--evaluate"]) == 0, name
        got[name] = json.loads((flow[f"{name}_session"] / "evaluation" / "evaluation_metrics.json").read_text())
    assert got["port"] == got["jax"]
    assert got["port"]["true_positives"] == len(annotations) > 0 and got["port"]["false_negatives"] == 0


# ---------------------------------------------------------------------- main
def test_main_missing_config_returns_1(tmp_path):
    assert port_main(["--config", str(tmp_path / "missing.yaml")]) == 1


def test_main_invalid_config_returns_1(tmp_path, video):
    cfg = write_config(tmp_path / "c.yaml", flow_config(tmp_path / "out", video, **{"detection.batch_size": 0}))
    assert port_main(["--config", str(cfg)]) == 1


def test_main_timestamps_only_matches_jax(tmp_path, flow, video):
    """Phase 1 alone, with the frames of the JAX run of the same config."""
    cfg = write_config(tmp_path / "c.yaml", flow_config(tmp_path / "out", video))
    assert port_main(["--config", str(cfg), "--timestamps-only"]) == 0
    (session,) = sessions(tmp_path / "out")
    assert read_extraction_csv(session / "01_extraction" / "extraction_results.csv") == read_extraction_csv(
        flow["jax_session"] / "01_extraction" / "extraction_results.csv")
    summary = json.loads((session / "summary.json").read_text())
    assert summary["status"] == "completed" and set(summary["performance"]) == {"01_extraction"}
    assert not any((session / "02_detection").iterdir())


def test_missing_video_returns_1_like_jax_main(tmp_path):
    """A config whose video does not exist is a configuration error in both
    entry points."""
    for name, entry in (("port", port_main), ("jax", jax_main)):
        cfg = write_config(tmp_path / f"{name}.yaml", flow_config(tmp_path / name, tmp_path / "none.mp4"))
        assert entry(["--config", str(cfg), "--timestamps-only"]) == 1, name


#: Configurations that ran into a refusal, or ran another route, before this
#: slice and run now: the I420 transfer route (A.4), ``auto``'s race (it ran
#: bgr) and the YOLOv8 detector (A.7b; tiny, seeded init).
RUNS = {
    "i420": {"detection.transfer_format": "i420"},
    "auto": {"detection.transfer_format": "auto"},
    "yolo": {"detection.model": "yolo", "detection.model_size": "tiny", "detection.checkpoint_path": None,
             "detection.confidence_threshold": 0.0},
}


#: The keys of the JAX phase's detection_statistics.json for a DETR detector.
STATISTICS_KEYS = {"total_frames", "total_detections", "avg_detections_per_frame", "max_detections_per_frame",
                   "min_detections_per_frame", "confidence", "transfer_format"}


@pytest.mark.parametrize("case", list(RUNS))
def test_main_runs_what_was_refused(tmp_path, video, case):
    """``main`` on the synthetic video to ``summary.json`` and
    ``zone_counts.csv``, with the upload or the detector the case names."""
    cfg = write_config(tmp_path / "c.yaml", flow_config(tmp_path / "out", video, **RUNS[case]))
    assert port_main(["--config", str(cfg)]) == 0
    (session,) = sessions(tmp_path / "out")
    summary = json.loads((session / "summary.json").read_text())
    assert summary["status"] == "completed" and "02_detection" in summary["performance"]
    assert (session / "05_aggregation" / "zone_counts.csv").exists()
    stats = json.loads((session / "02_detection" / "detection_statistics.json").read_text())
    assert stats["total_frames"] == 3
    if case == "yolo":
        assert "transfer_format" not in stats and stats["total_detections"] > 0
    else:  # the JAX phase's keys: the race's winner is recorded, its times only logged
        want = set(TRANSFER_FORMATS) if case == "auto" else {case}
        assert stats["transfer_format"] in want and set(stats) == STATISTICS_KEYS


REFUSALS = {
    "distributed": ({"parallel.distributed.enabled": True}, [], "A.8"),
    "side_by_side_video": ({"output.save_side_by_side_video": True}, [], "A.3"),
    "attention_maps": ({"output.save_attention_maps": True}, [], "A.3"),
    "fine_tune": ({"training.model": "yolo"}, ["--fine-tune"], "A.7"),  # the YOLO trainer
}


#: Refused until their item landed (A.8, A.7c); the cases now hold what runs
#: in their place.
LANDED = {"distributed", "fine_tune"}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_main_refuses_what_is_not_ported(tmp_path, video, capsys, monkeypatch, case):
    """The A.3 keys are refused before a session is written. Since A.8
    ``parallel.distributed.enabled`` starts the process group with the
    config's ``parallel.distributed.*`` (as the root ``main.py`` hands them
    to ``jax.distributed.initialize``) and the run completes; since A.7c
    ``--fine-tune`` with ``training.model: yolo`` hands the root
    ``main.py``'s argument list, ``--yolo-variant`` included, to the trainer."""
    overrides, flags, item = REFUSALS[case]
    if case in LANDED:
        from office_person_detection_vit_torch import train_detr
        from office_person_detection_vit_torch.parallel import mesh

        seen = []
        monkeypatch.setattr(mesh, "initialize_distributed", lambda **kw: seen.append(kw))
        monkeypatch.setattr(train_detr, "main", lambda argv: seen.append(argv) or 0)
        extra = ({"parallel.distributed.coordinator_address": "127.0.0.1:29511",
                  "parallel.distributed.num_processes": 1, "parallel.distributed.process_id": 0}
                 if case == "distributed" else {"training.yolo_variant": "x"})
        cfg = write_config(tmp_path / "c.yaml", flow_config(tmp_path / "out", video, **overrides, **extra))
        assert port_main(["--config", str(cfg), *flags]) == 0
        if case == "distributed":
            assert seen == [dict(coordinator_address="127.0.0.1:29511", num_processes=1, process_id=0)]
            (session,) = sessions(tmp_path / "out")
            assert json.loads((session / "summary.json").read_text())["status"] == "completed"
        else:
            (argv,) = seen
            assert argv[argv.index("--model") + 1] == "yolo" and argv[argv.index("--yolo-variant") + 1] == "x"
        return
    cfg = write_config(tmp_path / "c.yaml", flow_config(tmp_path / "out", video, **overrides))
    assert port_main(["--config", str(cfg), *flags]) == 2
    assert sessions(tmp_path / "out") == []
    log = capsys.readouterr().out  # main's log handler writes to stdout
    assert "NotImplementedError" in log and f"ROADMAP {item}" in log
    if overrides and not flags:  # a config key the orchestrator itself refuses
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            PipelineOrchestrator(ConfigManager.from_dict(flow_config(tmp_path / "out", video, **overrides)))
        assert sessions(tmp_path / "out") == []


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where there is no card")
@pytest.mark.parametrize("device", ["auto", "cuda"])
def test_main_asks_for_the_card_and_has_none(tmp_path, video, device):
    cfg = write_config(tmp_path / "c.yaml", flow_config(tmp_path / "out", video, **{"detection.device": device}))
    assert port_main(["--config", str(cfg)]) == 2
    assert sessions(tmp_path / "out") == []


# ----------------------------------------------------------- config and CLI
def _leaves(d: dict, prefix: str = ""):
    for k, v in d.items():
        if isinstance(v, dict) and v:
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}"


CONFIG_SOURCES = {
    "repo_yaml": lambda m, tmp: m.ConfigManager(REPO / "config.yaml"),
    "dict": lambda m, tmp: m.ConfigManager.from_dict(flow_config(tmp, tmp / "v.mp4")),
    "empty": lambda m, tmp: m.ConfigManager.from_dict({}),
    "no_defaults": lambda m, tmp: m.ConfigManager.from_dict({"detection": {"batch_size": 3}}, apply_defaults=False),
}


@pytest.mark.parametrize("source", list(CONFIG_SOURCES))
def test_config_manager_matches_jax(tmp_path, source):
    from office_person_detection_vit_torch.config import config_manager as port_config

    port, ref = (CONFIG_SOURCES[source](m, tmp_path) for m in (port_config, jax_config))
    assert port.as_dict() == ref.as_dict()
    for key in _leaves(ref.as_dict()):
        assert port.get(key) == ref.get(key), key
    assert port.get("no.such.key", "fallback") == ref.get("no.such.key", "fallback") == "fallback"
    for p, r in ((port, ref),):
        p.set("detection.batch_size", 16)
        r.set("detection.batch_size", 16)
        p.set("brand.new.key", [1, 2])
        r.set("brand.new.key", [1, 2])
    assert port.as_dict() == ref.as_dict()
    if source != "no_defaults":
        assert vars(port.static_hparams()) == vars(ref.static_hparams())
        assert port.validate() is ref.validate() is True
    for suffix in (".yaml", ".json"):
        assert port.save(tmp_path / f"p{suffix}").read_text() == ref.save(tmp_path / f"j{suffix}").read_text()


INVALID = {
    "missing_section": {"output": None},
    "bad_type": {"detection": {"batch_size": "8"}},
    "confidence_range": {"detection": {"confidence_threshold": 1.5}},
    "batch_size": {"detection": {"batch_size": 0}},
    "weights": {"tracking": {"appearance_weight": 0.5, "motion_weight": 0.2}},
    "weight_type": {"tracking": {"appearance_weight": "high"}},
    "calibration_flag": {"calibration": {"use_intrinsics": "yes"}},
    "reprojection": {"calibration": {"reprojection_error_threshold": 0}},
    "transform_method": {"transform": {"method": "affine"}},
    "zone_no_id": {"zones": [{"polygon": [[0, 0], [1, 0], [1, 1]]}]},
    "zone_duplicate": {"zones": [{"id": "a", "polygon": [[0, 0], [1, 0], [1, 1]]},
                                 {"id": "a", "polygon": [[0, 0], [1, 0], [1, 1]]}]},
    "zone_polygon": {"zones": [{"id": "a", "polygon": [[0, 0], [1, 0]]}]},
}


@pytest.mark.parametrize("case", list(INVALID))
def test_config_validate_rejects_what_jax_rejects(case):
    from office_person_detection_vit_torch.config import config_manager as port_config

    messages = []
    for m in (port_config, jax_config):
        with pytest.raises(m.ConfigValidationError) as e:
            m.ConfigManager.from_dict(INVALID[case]).validate()
        messages.append(str(e.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("device", ["tpu", "gpu", "cuda:x"])
def test_config_validate_rejects_a_device_the_port_lacks(device):
    with pytest.raises(ConfigValidationError, match="detection.device"):
        ConfigManager.from_dict({"detection": {"device": device}}).validate()
    for ok in ("auto", "cuda", "cuda:1", "CPU"):
        assert ConfigManager.from_dict({"detection": {"device": ok}}).validate()


@pytest.mark.parametrize("argv", [[], ["--config", "x.yaml", "--debug"], ["--evaluate", "--fine-tune"],
                                  ["--start-time", "2025-01-01 10:00:00", "--end-time", "2025-01-01 18:00",
                                   "--timestamps-only"], ["--resume", "output/20250101_000000"]])
def test_cli_matches_jax(argv):
    assert vars(parse_arguments(argv)) == vars(jax_parse_arguments(argv))


def test_parse_datetime_range_matches_jax(tmp_path, video):
    port = PipelineOrchestrator(ConfigManager.from_dict(flow_config(tmp_path / "p", video)))
    ref = JaxPipelineOrchestrator(jax_config.ConfigManager.from_dict(flow_config(tmp_path / "j", video)))
    for args in (("2025-01-20 09:00:00", "2025-01-20 09:10"), ("2025-01-20T09:00:00", None), (None, None)):
        assert port.parse_datetime_range(*args) == ref.parse_datetime_range(*args)
    with pytest.raises(ValueError):
        port.parse_datetime_range("yesterday", None)


# ------------------------------------------------------------------ services
def _mask(state: dict) -> dict:
    """A checkpoint's state with its clocks and directory masked."""
    state = json.loads(json.dumps(state))
    for k in ("created_at", "last_updated", "session_dir"):
        state[k] = "*"
    for entry in state["phases"].values():
        entry["timestamp"] = "*"
    return state


def test_checkpoint_service_matches_jax(tmp_path):
    states = {}
    for name, cls in (("port", CheckpointService), ("jax", JaxCheckpointService)):
        svc = cls(tmp_path / name)
        svc.save("01_extraction", data={"frames_extracted": 4})
        svc.save("02_detection", status="failed")
        svc.save("02_detection", data={"total_detections": 7})
        svc.save("03_tracking", status="skipped")
        reopened = cls(tmp_path / name)
        states[name] = (_mask(json.loads((tmp_path / name / "pipeline_checkpoint.json").read_text())),
                        reopened.last_completed(), reopened.resumable_phase(), reopened.summary(),
                        reopened.phase_data("01_extraction"), reopened.is_completed("03_tracking"))
    assert states["port"] == states["jax"]


def test_output_service_matches_jax(tmp_path):
    trees = {}
    for name, cls in (("port", OutputService), ("jax", JaxOutputService)):
        svc = cls(tmp_path / name)
        session = svc.setup({"video": {"input_path": "x.mp4"}, "output": {}}, session_id="20250120_090000")
        svc.save_summary({"status": "completed"})
        trees[name] = (sorted(str(p.relative_to(tmp_path / name)) for p in (tmp_path / name).rglob("*")),
                       (session / "config.yaml").read_text(), svc.get_phase_dir("detection").name,
                       os.readlink(tmp_path / name / "latest"), svc.session_id)
        assert cls(tmp_path / name).attach(session) == session
    assert trees["port"] == trees["jax"]


def test_session_retention_matches_jax(tmp_path):
    now = datetime.now()
    old, ancient = (now - timedelta(days=45)).strftime("%Y%m%d_%H%M%S"), (now - timedelta(days=120)).strftime(
        "%Y%m%d_%H%M%S")
    results = {}
    for name, cls in (("port", OutputManager), ("jax", JaxOutputManager)):
        base = tmp_path / name
        for sid in (old, "not_a_session"):
            (base / sid).mkdir(parents=True)
            (base / sid / "metadata.json").write_text("{}")
        (base / "archive" / ancient).mkdir(parents=True)
        mgr = cls(base)
        mgr.create_session("20990101_000000")
        results[name] = (mgr.archive_old_sessions(30, 90), mgr.list_sessions(),
                         sorted(p.name for p in (base / "archive").iterdir()))
    assert results["port"] == results["jax"] and results["port"][0] == (1, 1)


def test_performance_monitor_matches_jax():
    summaries = []
    for cls in (PerformanceMonitor, JaxPerformanceMonitor):
        mon = cls()
        for name in ("01_extraction", "02_detection", "02_detection"):
            with mon.measure(name):
                pass
        summaries.append({k: (set(v), v["count"]) for k, v in mon.get_summary().items()})
    assert summaries[0] == summaries[1] == {"01_extraction": (summaries[1]["01_extraction"][0], 1),
                                            "02_detection": (summaries[1]["02_detection"][0], 2)}


def test_performance_trace_holds_the_scopes(tmp_path):
    """``performance.trace_dir``: the run is traced by torch.profiler and
    each measured scope is a range in the trace."""
    mon = PerformanceMonitor()
    mon.start_trace(str(tmp_path / "trace"))
    with mon.measure("02_detection"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = mon.stop_trace()
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "02_detection" in names and mon.stop_trace() is None


def test_memory_utils(tmp_path):
    class Phase:
        cleaned = 0

        def cleanup(self):
            Phase.cleaned += 1

    memory_utils.cleanup_resources(Phase(), object(), Phase())
    assert Phase.cleaned == 2
    assert memory_utils.live_device_bytes() == (0 if not torch.cuda.is_available() else memory_utils.live_device_bytes())


@pytest.mark.parametrize("debug", [False, True])
def test_setup_logging_matches_jax(tmp_path, debug):
    import logging

    got = logging_utils.setup_logging(debug=debug, output_dir=tmp_path / "p")
    got = [(type(h).__name__, h.level) for h in got.handlers]
    want = jax_logging_utils.setup_logging(debug=debug, output_dir=tmp_path / "j")
    want = [(type(h).__name__, h.level) for h in want.handlers]
    assert got == want and (tmp_path / "p" / "system.log").exists()
    logging_utils.setup_logging()


# ------------------------------------------------------------- visualization
def _frame_results(dto):
    rng = np.random.default_rng(5)
    frames = []
    for f in range(4):
        dets = []
        for q in range(3 if f != 2 else 0):
            d = dto.Detection(bbox=tuple(float(v) for v in rng.uniform([0, 0, 30, 80], [1200, 600, 60, 160])),
                              confidence=float(rng.uniform(0.3, 1)), track_id=q if f % 2 else None)
            d.floor_coords_px = tuple(float(v) for v in rng.uniform([50, 50], [1800, 1300]))
            if q == 1 and f == 3:
                d.floor_coords_px = None
            dets.append(d)
        frames.append(dto.FrameResult(f, T0 + timedelta(minutes=5 * f), dets, zone_counts={"zone_1": f, "zone_2": 1}))
    return frames


def test_floormap_visualizer_is_pixel_equal_to_jax(tmp_path):
    cfg = {"zones": ZONES, "camera": {"position_x": 900, "position_y": 1200}}
    images = {}
    for name, cls, dto in (("port", FloormapVisualizer, port_dto), ("jax", JaxFloormapVisualizer, jax_dto)):
        vis, frs = cls(ConfigManager.from_dict(cfg)), _frame_results(dto)
        images[name] = [vis.visualize_frame(fr, tmp_path / name / f"{i}.png",
                                            trajectories=vis.collect_trajectories(frs, up_to=i))
                        for i, fr in enumerate(frs)]
    for got, want in zip(images["port"], images["jax"]):
        assert got.shape == (1369, 1878, 3) and np.array_equal(got, want)


def test_charts_match_jax_in_size(tmp_path):
    import cv2

    results = [jax_dto.AggregationResult(f"2025-01-20 09:{5 * i:02d}:00", {"zone_1": i % 3, "zone_2": 1})
               for i in range(7)]
    stats = {"zone_1": {"avg": 1.0, "max": 2}, "zone_2": {"avg": 1.0, "max": 1}}
    port_results = [port_dto.AggregationResult(r.timestamp, r.zone_counts) for r in results]
    for method, args in (("plot_time_series", (results,)), ("plot_zone_statistics", (stats,)),
                         ("plot_heatmap", (results,))):
        port_args = (port_results,) if args[0] is results else args
        got = getattr(Visualizer(), method)(*port_args, tmp_path / f"p_{method}.png")
        want = getattr(JaxVisualizer(), method)(*args, tmp_path / f"j_{method}.png")
        assert cv2.imread(str(got)).shape == cv2.imread(str(want)).shape, method
    frame = np.random.default_rng(0).integers(0, 255, (72, 128, 3), np.uint8)
    amap = np.random.default_rng(1).random((3, 4)).astype(np.float32)
    assert np.array_equal(Visualizer().overlay_attention_map(frame, amap), JaxVisualizer().overlay_attention_map(frame, amap))


def test_visualization_phase_matches_jax(tmp_path):
    cfg = {"zones": ZONES, "output": {"save_floormap_images": True}}
    outputs = {}
    for name, cls, dto in (("port", VisualizationPhase, port_dto), ("jax", JaxVisualizationPhase, jax_dto)):
        frs = _frame_results(dto)
        agg = [dto.AggregationResult(fr.timestamp_str, fr.zone_counts) for fr in frs]
        made = cls(ConfigManager.from_dict(cfg)).execute(frs, agg, tmp_path / name,
                                                         zone_statistics={"zone_1": {"avg": 1.5, "max": 3}})
        outputs[name] = (sorted(made), sorted(p.name for p in (tmp_path / name).rglob("*")))
    assert outputs["port"] == outputs["jax"]
    for png in (tmp_path / "jax" / "floormaps").iterdir():
        import cv2

        assert np.array_equal(cv2.imread(str(tmp_path / "port" / "floormaps" / png.name)), cv2.imread(str(png)))


def test_visualization_phase_without_charts(tmp_path):
    """``output.save_charts: false`` (a machine without matplotlib): the
    floormaps only."""
    frs = _frame_results(port_dto)
    cfg = ConfigManager.from_dict({"zones": ZONES, "output": {"save_floormap_images": True, "save_charts": False}})
    made = VisualizationPhase(cfg).execute(frs, [], tmp_path)
    assert made == {"floormaps": 4} and sorted(p.name for p in tmp_path.iterdir()) == ["floormaps"]
    with pytest.raises(NotImplementedError, match="ROADMAP A.3"):
        VisualizationPhase(ConfigManager.from_dict({"output": {"save_side_by_side_video": True}}))
