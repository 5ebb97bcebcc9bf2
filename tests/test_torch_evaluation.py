"""The port's detection evaluation (``evaluation/evaluation_module.py``,
``benchmark/detection_benchmark.py``, ``benchmark/detection_runner.py``)
against the JAX package's on the same records, made with numpy from a seed.
Host numpy on both sides in the same order: every number must be exact."""

import json

import numpy as np
import pytest

from office_person_detection_vit_torch.benchmark import detection_benchmark as port_bench
from office_person_detection_vit_torch.benchmark import detection_runner as port_runner
from office_person_detection_vit_torch.core import dto as port_dto
from office_person_detection_vit_torch.evaluation import evaluation_module as port_eval
from office_person_detection_vit_tpu.benchmark import detection_benchmark as jax_bench
from office_person_detection_vit_tpu.benchmark import detection_runner as jax_runner
from office_person_detection_vit_tpu.core import dto as jax_dto
from office_person_detection_vit_tpu.evaluation import evaluation_module as jax_eval


def _scene(seed: int, images: int = 12):
    """GT boxes a frame and predictions near them (jittered, some missing,
    some false), each with a score, in 1280x720 pixels."""
    rng = np.random.default_rng(seed)
    gt, preds = {}, []
    for i in range(images):
        name = f"frame_{i:04d}.jpg"
        n = int(rng.integers(0, 6))
        xy = rng.uniform(0, 1100, (n, 2))
        wh = rng.uniform(30, 180, (n, 2))
        boxes = np.concatenate([xy, wh], 1).astype(np.float32)
        gt[name] = boxes
        for b in boxes:
            if rng.random() < 0.8:
                preds.append((name, tuple(float(v) for v in b + rng.normal(0, 12, 4)), float(rng.random())))
        for _ in range(int(rng.integers(0, 3))):
            preds.append((name, tuple(float(v) for v in rng.uniform(0, 600, 4) + [0, 0, 40, 40]),
                          float(rng.random())))
    return gt, preds


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou", [0.5, 0.3])
def test_greedy_match_matches_jax(seed, iou):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        p = rng.uniform(0, 200, (int(rng.integers(0, 8)), 4)).astype(np.float32)
        g = rng.uniform(0, 200, (int(rng.integers(0, 8)), 4)).astype(np.float32)
        assert port_eval.greedy_match(p, g, iou) == jax_eval.greedy_match(p, g, iou)


@pytest.mark.parametrize("seed", [0, 3])
def test_evaluation_module_matches_jax(seed):
    gt, preds = _scene(seed)
    gt_lists = {k: v.tolist() for k, v in gt.items()}
    got, want = {}, {}
    for name, box, score in preds:
        got.setdefault(name, []).append(port_dto.Detection(bbox=box, confidence=score))
        want.setdefault(name, []).append(jax_dto.Detection(bbox=box, confidence=score))
    a = port_eval.EvaluationModule(0.5).evaluate(got, gt_lists)
    b = jax_eval.EvaluationModule(0.5).evaluate(want, gt_lists)
    assert a.to_dict() == b.to_dict() and a.true_positives > 0


def _records(module, preds):
    return [module.DetectionRecord(name, box, score) for name, box, score in preds]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("ap_mode", ["standard", "reference"])
def test_detection_benchmark_ap_matches_jax(seed, ap_mode):
    gt, preds = _scene(seed)
    a = port_bench.DetectionBenchmark(iou_threshold=0.5, ap_mode=ap_mode).evaluate(_records(port_bench, preds), gt)
    b = jax_bench.DetectionBenchmark(iou_threshold=0.5, ap_mode=ap_mode).evaluate(_records(jax_bench, preds), gt)
    assert a.to_dict() == b.to_dict()
    assert a.per_image == b.per_image
    assert 0 < a.ap50 <= 1 and a.map_5095 <= a.ap50


@pytest.mark.parametrize("seed", [0, 1])
def test_threshold_sweep_matches_jax(seed):
    gt, preds = _scene(seed)
    assert port_bench.threshold_sweep(_records(port_bench, preds), gt) == \
        jax_bench.threshold_sweep(_records(jax_bench, preds), gt)


def _coco_files(tmp_path, gt, preds):
    names = sorted(gt)
    coco = {"images": [{"id": i, "file_name": n, "width": 1280, "height": 720} for i, n in enumerate(names)],
            "annotations": [{"id": j, "image_id": names.index(n), "bbox": [float(v) for v in b], "category_id": 1}
                            for j, (n, b) in enumerate((n, b) for n in names for b in gt[n])]}
    gt_path = tmp_path / "gt.json"
    gt_path.write_text(json.dumps(coco))
    pred_path = tmp_path / "pred.json"
    pred_path.write_text(json.dumps([{"file_name": n, "bbox": list(b), "score": s} for n, b, s in preds]))
    return gt_path, pred_path


def test_files_reports_and_the_runner_match_jax(tmp_path, capsys):
    gt, preds = _scene(5)
    gt_path, pred_path = _coco_files(tmp_path, gt, preds)
    a = port_bench.DetectionBenchmark().evaluate_from_files(gt_path, pred_path)
    b = jax_bench.DetectionBenchmark().evaluate_from_files(gt_path, pred_path)
    assert a.to_dict() == b.to_dict()
    for name, runner in (("port", port_runner), ("jax", jax_runner)):
        assert runner.main(["--gt", str(gt_path), "--pred", str(pred_path), "--json", "--sweep",
                            "--report", str(tmp_path / name)]) == 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 2 and printed[0] == printed[1]
    port_files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert port_files == sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                                if p.is_file())
    for rel in port_files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def test_run_evaluation_matches_jax(tmp_path):
    """``main --evaluate``'s step: the pipeline's frame results joined to the
    GT file by the saved frame's file name, the report written."""
    gt, preds = _scene(7)
    gt_path, _ = _coco_files(tmp_path, gt, preds)
    results = {}
    for name, dto, module in (("port", port_dto, port_eval), ("jax", jax_dto, jax_eval)):
        frames = [dto.FrameResult(frame_number=i, timestamp=None, frame_path=f"/session/frames/{n}",
                                  detections=[dto.Detection(bbox=b, confidence=s) for m, b, s in preds if m == n])
                  for i, n in enumerate(sorted(gt))]
        cfg = {"evaluation.ground_truth_path": str(gt_path), "evaluation.iou_threshold": 0.5}
        metrics = module.run_evaluation(_Config(cfg), frames, tmp_path / name)
        results[name] = (metrics.to_dict(), (tmp_path / name / "evaluation" / "evaluation_metrics.csv").read_text())
    assert results["port"] == results["jax"]
    assert port_eval.run_evaluation(_Config({}), [], tmp_path / "none") is None


class _Config(dict):
    def get(self, key, default=None):
        return super().get(key, default)
