"""Detection benchmark CLI (the port's copy of
``office_person_detection_vit_tpu/benchmark/detection_runner.py``).

``python -m office_person_detection_vit_torch.benchmark.detection_runner
--gt coco_gt.json --pred coordinate_transformations.json [--iou 0.5]
[--score 0.0] [--report DIR] [--json] [--sweep]``.
"""

from __future__ import annotations

import argparse
import json
import sys

from .detection_benchmark import DetectionBenchmark, threshold_sweep


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Detection benchmark (COCO AP)")
    parser.add_argument("--gt", required=True, help="COCO ground-truth JSON")
    parser.add_argument("--pred", required=True,
                        help="predictions (COCO results or coordinate_transformations.json)")
    parser.add_argument("--iou", type=float, default=0.5)
    parser.add_argument("--score", type=float, default=0.0)
    parser.add_argument("--report", default=None, help="output dir for reports")
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--sweep", action="store_true",
                        help="also run the confidence-threshold sweep")
    parser.add_argument("--ap-mode", choices=("standard", "reference"),
                        default="standard",
                        help="'reference' reproduces the reference's AP formula "
                             "(11-point, recall normalized by matched preds — "
                             "inflated vs standard) for published-number parity")
    args = parser.parse_args(argv)

    bench = DetectionBenchmark(
        iou_threshold=args.iou, score_threshold=args.score, ap_mode=args.ap_mode
    )
    gt = bench.load_coco(args.gt)
    preds = bench.load_predictions(args.pred)
    result = bench.evaluate(preds, gt)

    if args.json:
        print(json.dumps(result.to_dict()))
    else:
        print(f"Precision      {result.precision:8.4f}")
        print(f"Recall         {result.recall:8.4f}")
        print(f"F1             {result.f1:8.4f}")
        print(f"AP@50          {result.ap50:8.4f}")
        print(f"AP@75          {result.ap75:8.4f}")
        print(f"mAP(0.5:0.95)  {result.map_5095:8.4f}")
    if args.report:
        bench.export(result, args.report)
        if args.sweep:
            sweep = threshold_sweep(preds, gt)
            from pathlib import Path

            (Path(args.report) / "threshold_analysis.json").write_text(
                json.dumps(sweep, indent=2)
            )
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
