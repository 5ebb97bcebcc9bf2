"""Detection benchmark, COCO-style AP: the port's copy of
``office_person_detection_vit_tpu/benchmark/detection_benchmark.py``.

P/R/F1 at a working threshold, AP@50 / AP@75 / mAP(0.5:0.95) from the
all-points interpolated PR curve, FP/FN diagnostics JSONL and a markdown
report. IoU matrices and the PR sweep are numpy on the host: the shapes
change with every image. The trainer's ``--evaluate`` scores with it.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np

from ..ops.boxes import iou_matrix_xywh_np

logger = logging.getLogger(__name__)

IOU_GRID = np.arange(0.5, 1.0, 0.05)


@dataclass
class DetectionRecord:
    image: str
    bbox: tuple[float, float, float, float]
    score: float


@dataclass
class BenchmarkResult:
    precision: float
    recall: float
    f1: float
    ap50: float
    ap75: float
    map_5095: float
    num_images: int
    num_gt: int
    tp: int = 0
    fp: int = 0
    fn: int = 0
    per_image: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "precision": self.precision,
            "recall": self.recall,
            "f1_score": self.f1,
            "ap_50": self.ap50,
            "ap_75": self.ap75,
            "map_50_95": self.map_5095,
            "num_images": self.num_images,
            "num_gt": self.num_gt,
            "true_positives": self.tp,
            "false_positives": self.fp,
            "false_negatives": self.fn,
        }


def _image_iou(
    preds: list[DetectionRecord], gt_boxes: np.ndarray
) -> np.ndarray:
    """(P, G) IoU matrix for one image — computed ONCE and reused across
    all ten AP thresholds (the matrix does not depend on the threshold)."""
    if len(preds) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(preds), len(gt_boxes)), np.float32)
    return iou_matrix_xywh_np(
        np.asarray([p.bbox for p in preds], np.float32), gt_boxes
    )


def _match_image_detail(
    iou: np.ndarray, iou_threshold: float
) -> tuple[np.ndarray, np.ndarray]:
    """Score-ordered greedy matching over a precomputed IoU matrix; returns
    (bool TP flag per pred, bool matched flag per GT). Rows must be sorted
    by descending score."""
    P, G = iou.shape
    tp_flags = np.zeros(P, bool)
    taken = np.zeros(G, bool)
    if P == 0 or G == 0:
        return tp_flags, taken
    for i in range(P):
        order = np.argsort(-iou[i])
        for g in order:
            if iou[i, g] < iou_threshold:
                break
            if not taken[g]:
                taken[g] = True
                tp_flags[i] = True
                break
    return tp_flags, taken


def _match_image(iou: np.ndarray, iou_threshold: float) -> np.ndarray:
    return _match_image_detail(iou, iou_threshold)[0]


def average_precision(
    tp_flags: np.ndarray, scores: np.ndarray, num_gt: int
) -> float:
    """All-points interpolated AP from global score-sorted TP flags."""
    if num_gt == 0 or len(tp_flags) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = tp_flags[order].astype(np.float64)
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(1.0 - tp)
    recall = cum_tp / num_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-12)
    # Monotone precision envelope, integrate over recall deltas.
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    r_prev = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - r_prev) * precision))


def reference_compat_ap(
    tp_flags: np.ndarray, scores: np.ndarray
) -> float:
    """The reference's AP formula, reproduced exactly for published-number
    comparisons (reference src/evaluation/detection_benchmark.py:434-472):
    11-point interpolation, and — crucially — recall normalized by the
    number of MATCHED predictions rather than by GT count, so false
    negatives never lower it. Against the reference's own committed
    artifacts this reproduces its detection_metrics.json to full float
    precision (AP@50 0.9519408122061515); the standard formula
    (:func:`average_precision`) gives 0.778 on the same data. Use
    ``ap_mode="reference"`` only to compare against the reference's
    published numbers."""
    if len(tp_flags) == 0:
        return 0.0
    order = np.argsort(-scores)
    f = tp_flags[order].astype(bool)
    total_pos = int(f.sum())
    if total_pos == 0:
        return 0.0
    tp = np.cumsum(f)
    fp = np.cumsum(~f)
    prec = tp / (tp + fp)
    rec = tp / total_pos
    ap = 0.0
    for t in np.arange(0, 1.1, 0.1):
        mask = rec >= t
        ap += (float(prec[mask].max()) if mask.any() else 0.0) / 11
    return float(ap)


class DetectionBenchmark:
    def __init__(
        self,
        iou_threshold: float = 0.5,
        score_threshold: float = 0.0,
        ap_mode: str = "standard",
    ):
        if ap_mode not in ("standard", "reference"):
            raise ValueError(f"unknown ap_mode: {ap_mode}")
        self.iou_threshold = float(iou_threshold)
        self.score_threshold = float(score_threshold)
        self.ap_mode = ap_mode

    # -------------------------------------------------------------- loading
    @staticmethod
    def load_coco(path: str | Path) -> dict[str, np.ndarray]:
        """COCO GT -> {file_name: (N, 4) xywh} (person class)."""
        doc = json.loads(Path(path).read_text())
        images = {img["id"]: img["file_name"] for img in doc.get("images", [])}
        gt: dict[str, list] = {name: [] for name in images.values()}
        for ann in doc.get("annotations", []):
            name = images.get(ann["image_id"])
            if name is not None:
                gt[name].append([float(v) for v in ann["bbox"]])
        return {k: np.asarray(v, np.float32).reshape(-1, 4) for k, v in gt.items()}

    @staticmethod
    def load_predictions(path: str | Path) -> list[DetectionRecord]:
        """Accepts COCO-results JSON ([{image_id/file_name, bbox, score}]),
        a full COCO document ({images, annotations} with per-annotation
        scores — the format the reference's detect_yolov8.py exporter writes,
        reference tools/detect_yolov8.py:4), or the pipeline's
        coordinate_transformations.json."""
        doc = json.loads(Path(path).read_text())
        records: list[DetectionRecord] = []
        if isinstance(doc, dict) and "annotations" in doc:
            images = {im["id"]: im["file_name"] for im in doc.get("images", [])}
            for ann in doc["annotations"]:
                name = images.get(ann.get("image_id"), str(ann.get("image_id", "")))
                records.append(
                    DetectionRecord(
                        str(name),
                        tuple(float(v) for v in ann["bbox"]),
                        float(ann.get("score", 1.0)),
                    )
                )
            return records
        if isinstance(doc, dict) and "frames" in doc:
            for frame in doc["frames"]:
                name = frame.get("image", frame.get("timestamp", frame.get("ts", "")))
                for d in frame.get("detections", frame.get("det", [])):
                    if "bbox" in d:
                        bb = (d["bbox"]["x"], d["bbox"]["y"], d["bbox"]["width"], d["bbox"]["height"])
                        score = d["confidence"]
                    else:
                        bb = tuple(d["bb"])
                        score = d["conf"]
                    records.append(DetectionRecord(str(name), bb, float(score)))
        else:
            for d in doc:
                name = d.get("file_name", str(d.get("image_id", "")))
                records.append(
                    DetectionRecord(name, tuple(d["bbox"]), float(d.get("score", 1.0)))
                )
        return records

    # ------------------------------------------------------------- evaluate
    def evaluate(
        self,
        predictions: list[DetectionRecord],
        ground_truth: dict[str, np.ndarray],
    ) -> BenchmarkResult:
        preds_by_image: dict[str, list[DetectionRecord]] = {}
        for p in predictions:
            if p.score >= self.score_threshold:
                preds_by_image.setdefault(p.image, []).append(p)
        for plist in preds_by_image.values():
            plist.sort(key=lambda p: -p.score)

        num_gt = int(sum(len(g) for g in ground_truth.values()))
        all_scores: list[float] = []
        flags_at: dict[float, list[np.ndarray]] = {t: [] for t in IOU_GRID}
        per_image: dict[str, Any] = {}
        tp = fp = fn = 0
        for name, gt_boxes in ground_truth.items():
            plist = preds_by_image.get(name, [])
            all_scores.extend(p.score for p in plist)
            iou = _image_iou(plist, gt_boxes)
            for t in IOU_GRID:
                flags_at[t].append(_match_image(iou, float(t)))
            # Working-point P/R/F1 honor the configured IoU threshold, which
            # need not be on the AP grid (--iou CLI flag).
            f_wp, gt_matched = _match_image_detail(iou, self.iou_threshold)
            itp = int(f_wp.sum())
            tp += itp
            fp += len(plist) - itp
            fn += len(gt_boxes) - itp
            # Per-box diagnostics (reference detection_benchmark.py:101-136
            # contract: detection_fp.jsonl with score + best_iou,
            # detection_fn.jsonl with the missed GT boxes).
            fp_boxes = [
                {
                    "bbox": [float(v) for v in p.bbox],
                    "score": float(p.score),
                    "best_iou": float(iou[i].max()) if iou.shape[1] else 0.0,
                }
                for i, p in enumerate(plist)
                if not f_wp[i]
            ]
            fn_boxes = [
                {"bbox": [float(v) for v in gt_boxes[g]], "gt_index": int(g)}
                for g in range(len(gt_boxes))
                if not gt_matched[g]
            ]
            per_image[name] = {
                "tp": itp,
                "fp": len(plist) - itp,
                "fn": len(gt_boxes) - itp,
                "fp_boxes": fp_boxes,
                "fn_boxes": fn_boxes,
            }

        scores = np.asarray(all_scores, np.float64)

        def _ap(flags: np.ndarray) -> float:
            if self.ap_mode == "reference":
                return reference_compat_ap(flags, scores)
            return average_precision(flags, scores, num_gt)

        ap = {
            t: _ap(np.concatenate(flags_at[t]) if flags_at[t] else np.zeros(0, bool))
            for t in IOU_GRID
        }
        precision = tp / (tp + fp) if (tp + fp) else 0.0
        recall = tp / (tp + fn) if (tp + fn) else 0.0
        f1 = 2 * precision * recall / (precision + recall) if (precision + recall) else 0.0
        return BenchmarkResult(
            precision=precision,
            recall=recall,
            f1=f1,
            ap50=ap[0.5],
            ap75=ap[IOU_GRID[5]],
            map_5095=float(np.mean(list(ap.values()))),
            num_images=len(ground_truth),
            num_gt=num_gt,
            tp=tp,
            fp=fp,
            fn=fn,
            per_image=per_image,
        )

    def evaluate_from_files(
        self, gt_path: str | Path, pred_path: str | Path
    ) -> BenchmarkResult:
        return self.evaluate(
            self.load_predictions(pred_path), self.load_coco(gt_path)
        )

    # -------------------------------------------------------------- reports
    def export(
        self,
        result: BenchmarkResult,
        output_dir: str | Path,
        diagnostics: bool = True,
    ) -> dict[str, Path]:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        paths: dict[str, Path] = {}
        paths["json"] = out / "detection_metrics.json"
        paths["json"].write_text(json.dumps(result.to_dict(), indent=2))
        if diagnostics:
            paths["diagnostics"] = out / "detection_diagnostics.jsonl"
            with paths["diagnostics"].open("w") as f:
                for name, d in result.per_image.items():
                    if d["fp"] or d["fn"]:
                        f.write(
                            json.dumps(
                                {"image": name, "tp": d["tp"], "fp": d["fp"], "fn": d["fn"]}
                            )
                            + "\n"
                        )
            # Per-box FP/FN files (reference diagnostics/ layout:
            # detection_fp.jsonl / detection_fn.jsonl).
            diag_dir = out / "diagnostics"
            diag_dir.mkdir(exist_ok=True)
            paths["fp_jsonl"] = diag_dir / "detection_fp.jsonl"
            paths["fn_jsonl"] = diag_dir / "detection_fn.jsonl"
            with paths["fp_jsonl"].open("w") as f:
                for name, d in result.per_image.items():
                    for box in d.get("fp_boxes", []):
                        f.write(json.dumps({"image": name, **box}) + "\n")
            with paths["fn_jsonl"].open("w") as f:
                for name, d in result.per_image.items():
                    for box in d.get("fn_boxes", []):
                        f.write(json.dumps({"image": name, **box}) + "\n")
        md = [
            "# Detection Benchmark",
            "",
            f"- images: {result.num_images}, GT boxes: {result.num_gt}",
            f"- Precision: {result.precision:.4f}",
            f"- Recall: {result.recall:.4f}",
            f"- F1: {result.f1:.4f}",
            f"- AP@50: {result.ap50:.4f}",
            f"- AP@75: {result.ap75:.4f}",
            f"- mAP(0.5:0.95): {result.map_5095:.4f}",
        ]
        paths["report"] = out / "detection_report.md"
        paths["report"].write_text("\n".join(md) + "\n")
        return paths


def threshold_sweep(
    predictions: list[DetectionRecord],
    ground_truth: dict[str, np.ndarray],
    thresholds: np.ndarray | None = None,
) -> dict[str, Any]:
    """F1 vs confidence threshold (reference tools/analyze_threshold.py +
    output/benchmark/threshold_yolov8.json contract)."""
    if thresholds is None:
        thresholds = np.arange(0.05, 0.95, 0.05)
    rows = []
    for t in thresholds:
        result = DetectionBenchmark(score_threshold=float(t)).evaluate(
            predictions, ground_truth
        )
        rows.append(
            {
                "threshold": round(float(t), 2),
                "precision": result.precision,
                "recall": result.recall,
                "f1": result.f1,
                "tp": result.tp,
                "fp": result.fp,
                "fn": result.fn,
            }
        )
    best = max(rows, key=lambda r: r["f1"])
    return {"sweep": rows, "best_threshold": best["threshold"], "best_f1": best["f1"]}
