"""Tracking benchmark (reference src/benchmark/tracking_benchmark.py:244-472).

Mirrors ``office_person_detection_vit_tpu/benchmark/tracking_benchmark.py``
over the port's ``mot_metrics``: the reference's file contracts (Gold-GT
JSON or MOT CSV ground truth vs the pipeline's ``tracks_mot.csv``); sparse
(5-minute interval) mode maps both sides onto a common frame index before
scoring; id-switch / lost-track diagnostics; json + markdown reports.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any

from .mot_metrics import (
    FrameAnnotations,
    MOTResult,
    evaluate_mot,
    load_gold_gt,
    load_mot_csv,
)

logger = logging.getLogger(__name__)


def _renumber_sparse(
    gt: FrameAnnotations, hyp: FrameAnnotations
) -> tuple[FrameAnnotations, FrameAnnotations]:
    """Collapse frame numbers onto consecutive indices (sparse 5-minute
    sampling mode, reference :244-269).

    Two numbering situations occur in practice:
    * both sides already share a frame space (e.g. both in video frame
      numbers) -> use ONE mapping over the union, so a frame missing on one
      side stays missing instead of silently shifting alignment;
    * disjoint spaces of equal length (GT in raw video frames, predictions
      in 1..N sample indices) -> align by sorted order per side.
    """
    gt_frames, hyp_frames = set(gt), set(hyp)
    if gt_frames & hyp_frames or len(gt_frames) != len(hyp_frames):
        mapping = {f: i + 1 for i, f in enumerate(sorted(gt_frames | hyp_frames))}
        return (
            {mapping[f]: v for f, v in gt.items()},
            {mapping[f]: v for f, v in hyp.items()},
        )
    logger.info(
        "sparse mode: disjoint equal-length frame sets; aligning by order"
    )
    return (
        {i + 1: gt[f] for i, f in enumerate(sorted(gt_frames))},
        {i + 1: hyp[f] for i, f in enumerate(sorted(hyp_frames))},
    )


class TrackingBenchmark:
    def __init__(self, sparse: bool = False):
        self.sparse = sparse

    def evaluate(
        self,
        gt: FrameAnnotations,
        hyp: FrameAnnotations,
        events_out: dict[str, list] | None = None,
    ) -> MOTResult:
        """``events_out`` (optional) receives per-event diagnostics from the
        SAME evaluation pass — after sparse renumbering, so event frame ids
        always agree with the reported metrics."""
        if self.sparse:
            gt, hyp = _renumber_sparse(gt, hyp)
        return evaluate_mot(gt, hyp, events_out=events_out)

    def evaluate_hota(self, gt: FrameAnnotations, hyp: FrameAnnotations):
        """HOTA / DetA / AssA (Luiten et al. 2021) — beyond the reference's
        motmetrics set; its Makefile advertises HOTA without implementing it."""
        from .mot_metrics import evaluate_hota

        if self.sparse:
            gt, hyp = _renumber_sparse(gt, hyp)
        return evaluate_hota(gt, hyp)

    def evaluate_from_files(
        self,
        gt_path: str | Path,
        pred_path: str | Path,
        gt_format: str = "gold",
        events_out: dict[str, list] | None = None,
    ) -> MOTResult:
        """(reference :271-298)"""
        gt = (
            load_gold_gt(gt_path)
            if gt_format == "gold"
            else load_mot_csv(gt_path)
        )
        hyp = load_mot_csv(pred_path)
        return self.evaluate(gt, hyp, events_out=events_out)

    # ---------------------------------------------------------- diagnostics
    @staticmethod
    def diagnostics(gt: FrameAnnotations, hyp: FrameAnnotations) -> dict[str, Any]:
        """Per-track presence summary for id-switch / lost-track analysis
        (reference :349-472)."""
        gt_spans: dict[int, list[int]] = {}
        hyp_spans: dict[int, list[int]] = {}
        for frame, anns in gt.items():
            for tid, _ in anns:
                gt_spans.setdefault(tid, []).append(frame)
        for frame, anns in hyp.items():
            for tid, _ in anns:
                hyp_spans.setdefault(tid, []).append(frame)

        def span(frames: list[int]) -> dict[str, int]:
            return {
                "first": min(frames),
                "last": max(frames),
                "observed": len(frames),
                "gaps": (max(frames) - min(frames) + 1) - len(frames),
            }

        return {
            "gt_tracks": {t: span(f) for t, f in sorted(gt_spans.items())},
            "hyp_tracks": {t: span(f) for t, f in sorted(hyp_spans.items())},
        }

    # -------------------------------------------------------------- reports
    @staticmethod
    def export(
        result: MOTResult,
        output_dir: str | Path,
        diagnostics: dict[str, Any] | None = None,
        hota=None,
        events: dict[str, list] | None = None,
    ) -> dict[str, Path]:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        paths: dict[str, Path] = {}
        doc = result.to_dict()
        if hota is not None:
            doc["hota"] = hota.to_dict()
        paths["json"] = out / "tracking_metrics.json"
        paths["json"].write_text(json.dumps(doc, indent=2))
        md = [
            "# Tracking Benchmark",
            "",
            f"- frames: {result.num_frames}, GT objects: {result.num_objects}",
            f"- MOTA: {result.mota:.4f}",
            f"- IDF1: {result.idf1:.4f}",
            f"- IDP: {result.idp:.4f}",
            f"- IDR: {result.idr:.4f}",
            f"- ID switches: {result.idsw}",
            f"- FP: {result.fp}, FN: {result.fn}",
        ]
        if hota is not None:
            md += [
                f"- HOTA: {hota.hota:.4f}",
                f"- DetA: {hota.det_a:.4f}",
                f"- AssA: {hota.ass_a:.4f}",
            ]
        paths["report"] = out / "tracking_report.md"
        paths["report"].write_text("\n".join(md) + "\n")
        if diagnostics is not None:
            paths["diagnostics"] = out / "tracking_diagnostics.json"
            paths["diagnostics"].write_text(json.dumps(diagnostics, indent=2))
        if events is not None:
            # Per-event JSONL files (reference diagnostics/ layout:
            # id_switches.jsonl / missed_detections.jsonl /
            # false_positives.jsonl).
            diag_dir = out / "diagnostics"
            diag_dir.mkdir(exist_ok=True)
            for name in ("id_switches", "missed_detections", "false_positives"):
                p = diag_dir / f"{name}.jsonl"
                with p.open("w") as fh:
                    for row in events.get(name, []):
                        fh.write(json.dumps(row) + "\n")
                paths[name] = p
        return paths
