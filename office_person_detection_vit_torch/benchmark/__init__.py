"""Benchmark helpers of the port: the MOT metrics that score
``tracks_mot.csv``. The tracking and detection benchmarks wait for ROADMAP
A.3a and A.3b."""

from .mot_metrics import HOTAResult, MOTResult, evaluate_hota, evaluate_mot, load_gold_gt, load_mot_csv

__all__ = ["HOTAResult", "MOTResult", "evaluate_hota", "evaluate_mot", "load_gold_gt", "load_mot_csv"]
