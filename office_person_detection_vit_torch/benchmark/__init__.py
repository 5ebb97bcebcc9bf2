"""Benchmark helpers and the tracking CLI of the port (reference
src/benchmark/__init__.py:37-216): the MOT metrics that score
``tracks_mot.csv``, the tracking benchmark over them, and the detection
benchmark (COCO AP) that the trainer's ``--evaluate`` and
``detection_runner`` use.

``python -m office_person_detection_vit_torch.benchmark --gt gt.json --pred
tracks_mot.csv [--gt-format gold|mot] [--sparse] [--report DIR] [--json]``
prints what the JAX package's CLI prints, from the same files.
"""

from __future__ import annotations

import argparse
import json
import sys

from .detection_benchmark import BenchmarkResult, DetectionBenchmark, DetectionRecord, threshold_sweep
from .mot_metrics import HOTAResult, MOTResult, evaluate_hota, evaluate_mot, load_gold_gt, load_mot_csv
from .tracking_benchmark import TrackingBenchmark

__all__ = ["BenchmarkResult", "DetectionBenchmark", "DetectionRecord", "HOTAResult", "MOTResult",
           "TrackingBenchmark", "evaluate_hota", "evaluate_mot", "load_gold_gt", "load_mot_csv", "main",
           "threshold_sweep"]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Tracking benchmark (MOT metrics)")
    parser.add_argument("--gt", required=True, help="ground-truth file")
    parser.add_argument("--pred", required=True, help="predicted tracks_mot.csv")
    parser.add_argument("--gt-format", choices=["gold", "mot"], default="gold")
    parser.add_argument("--sparse", action="store_true", help="sparse (interval-sampled) mode")
    parser.add_argument("--report", default=None, help="output dir for reports")
    parser.add_argument("--json", action="store_true", help="print JSON only")
    args = parser.parse_args(argv)

    bench = TrackingBenchmark(sparse=args.sparse)
    events: dict[str, list] = {}
    result = bench.evaluate_from_files(args.gt, args.pred, gt_format=args.gt_format,
                                       events_out=events if args.report else None)
    gt = load_gold_gt(args.gt) if args.gt_format == "gold" else load_mot_csv(args.gt)
    hyp = load_mot_csv(args.pred)
    hota = bench.evaluate_hota(gt, hyp)

    if args.json:
        doc = result.to_dict()
        doc["hota"] = hota.to_dict()
        print(json.dumps(doc))
    else:
        print(f"MOTA   {result.mota:8.4f}")
        print(f"IDF1   {result.idf1:8.4f}")
        print(f"IDP    {result.idp:8.4f}")
        print(f"IDR    {result.idr:8.4f}")
        print(f"HOTA   {hota.hota:8.4f}")
        print(f"DetA   {hota.det_a:8.4f}")
        print(f"AssA   {hota.ass_a:8.4f}")
        print(f"IDSW   {result.idsw:8d}")
        print(f"FP     {result.fp:8d}")
        print(f"FN     {result.fn:8d}")
    if args.report:
        TrackingBenchmark.export(result, args.report, TrackingBenchmark.diagnostics(gt, hyp), hota=hota,
                                 events=events)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
