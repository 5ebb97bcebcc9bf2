"""Benchmark helpers of the port: the MOT metrics that score
``tracks_mot.csv`` and the detection benchmark (COCO AP) that the trainer's
``--evaluate`` and ``detection_runner`` use. The tracking benchmark waits
for ROADMAP A.3b."""

from .detection_benchmark import BenchmarkResult, DetectionBenchmark, DetectionRecord, threshold_sweep
from .mot_metrics import HOTAResult, MOTResult, evaluate_hota, evaluate_mot, load_gold_gt, load_mot_csv

__all__ = ["BenchmarkResult", "DetectionBenchmark", "DetectionRecord", "HOTAResult", "MOTResult", "evaluate_hota",
           "evaluate_mot", "load_gold_gt", "load_mot_csv", "threshold_sweep"]
