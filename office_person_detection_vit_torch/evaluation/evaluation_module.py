"""Detection evaluation against COCO ground truth: the port's copy of
``office_person_detection_vit_tpu/evaluation/evaluation_module.py``.

Greedy IoU >= 0.5 matching per image -> precision/recall/F1, with the IoU
matrix computed as one broadcast (``ops/boxes.iou_matrix_xywh_np``, host
numpy: the shapes change with every image). The ground truth is joined by
file name. ``main --evaluate`` calls :func:`run_evaluation` after the
pipeline with the frames Phase 1 saved.
"""

from __future__ import annotations

import csv
import json
import logging
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from ..core.dto import Detection, EvaluationMetrics, FrameResult
from ..ops.boxes import iou_matrix_xywh_np

logger = logging.getLogger(__name__)


def greedy_match(
    pred_boxes: np.ndarray, gt_boxes: np.ndarray, iou_threshold: float = 0.5
) -> tuple[int, int, int]:
    """(P,4) xywh preds vs (G,4) xywh GT -> (tp, fp, fn), greedy by best IoU
    per GT in prediction-confidence order (caller pre-sorts preds)."""
    if len(pred_boxes) == 0:
        return 0, 0, len(gt_boxes)
    if len(gt_boxes) == 0:
        return 0, len(pred_boxes), 0
    iou = iou_matrix_xywh_np(pred_boxes, gt_boxes)
    matched_gt: set[int] = set()
    tp = 0
    for p in range(iou.shape[0]):
        order = np.argsort(-iou[p])
        for g in order:
            if iou[p, g] < iou_threshold:
                break
            if int(g) not in matched_gt:
                matched_gt.add(int(g))
                tp += 1
                break
    fp = iou.shape[0] - tp
    fn = iou.shape[1] - tp
    return tp, fp, fn


class EvaluationModule:
    def __init__(self, iou_threshold: float = 0.5):
        self.iou_threshold = float(iou_threshold)

    # ------------------------------------------------------------------ GT
    @staticmethod
    def load_coco_ground_truth(path: str | Path) -> dict[str, list[list[float]]]:
        """COCO-format file -> {file_name: [xywh, ...]} (person boxes)."""
        doc = json.loads(Path(path).read_text())
        images = {img["id"]: img["file_name"] for img in doc.get("images", [])}
        gt: dict[str, list[list[float]]] = {name: [] for name in images.values()}
        for ann in doc.get("annotations", []):
            name = images.get(ann["image_id"])
            if name is None:
                continue
            gt[name].append([float(v) for v in ann["bbox"]])
        return gt

    # ---------------------------------------------------------------- eval
    def evaluate(
        self,
        predictions: dict[str, list[Detection]],
        ground_truth: dict[str, list[list[float]]],
    ) -> EvaluationMetrics:
        """Filename-keyed predictions vs GT."""
        tp = fp = fn = 0
        for name, gt_boxes in ground_truth.items():
            dets = sorted(
                predictions.get(name, []), key=lambda d: -d.confidence
            )
            t, f, n = greedy_match(
                np.asarray([d.bbox for d in dets], np.float32).reshape(-1, 4),
                np.asarray(gt_boxes, np.float32).reshape(-1, 4),
                self.iou_threshold,
            )
            tp += t
            fp += f
            fn += n
        precision = tp / (tp + fp) if (tp + fp) else 0.0
        recall = tp / (tp + fn) if (tp + fn) else 0.0
        f1 = (
            2 * precision * recall / (precision + recall)
            if (precision + recall)
            else 0.0
        )
        return EvaluationMetrics(
            precision=precision,
            recall=recall,
            f1_score=f1,
            true_positives=tp,
            false_positives=fp,
            false_negatives=fn,
        )

    # -------------------------------------------------------------- report
    def export_report(
        self, metrics: EvaluationMetrics, output_dir: str | Path
    ) -> dict[str, Path]:
        """JSON + CSV report."""
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        json_path = out / "evaluation_metrics.json"
        json_path.write_text(json.dumps(metrics.to_dict(), indent=2), encoding="utf-8")
        csv_path = out / "evaluation_metrics.csv"
        with csv_path.open("w", newline="", encoding="utf-8") as f:
            writer = csv.writer(f)
            d = metrics.to_dict()
            writer.writerow(d.keys())
            writer.writerow(d.values())
        return {"json": json_path, "csv": csv_path}


def run_evaluation(
    config: Any,
    frame_results: Sequence[FrameResult],
    output_dir: str | Path,
) -> EvaluationMetrics | None:
    """``main --evaluate``: joins the pipeline's detections to the
    configured GT file (``evaluation.ground_truth_path``) by the saved
    frame's file name, writes ``evaluation/evaluation_metrics.{json,csv}``
    under ``output_dir``; ``None`` (with a warning) without a GT file."""
    gt_path = config.get("evaluation.ground_truth_path", None)
    if not gt_path or not Path(gt_path).exists():
        logger.warning("no ground truth at %s; skipping evaluation", gt_path)
        return None
    module = EvaluationModule(
        iou_threshold=float(config.get("evaluation.iou_threshold", 0.5))
    )
    gt = module.load_coco_ground_truth(gt_path)
    predictions = {
        Path(fr.frame_path).name: fr.detections
        for fr in frame_results
        if fr.frame_path
    }
    metrics = module.evaluate(predictions, gt)
    module.export_report(metrics, Path(output_dir) / "evaluation")
    logger.info(
        "evaluation: P %.4f R %.4f F1 %.4f (tp %d fp %d fn %d)",
        metrics.precision, metrics.recall, metrics.f1_score,
        metrics.true_positives, metrics.false_positives, metrics.false_negatives,
    )
    return metrics
