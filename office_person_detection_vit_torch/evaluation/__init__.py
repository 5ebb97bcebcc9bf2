"""Evaluation of the port: detection against COCO ground truth (``main
--evaluate``) and transform accuracy against floor correspondences."""

from .evaluation_module import EvaluationModule, greedy_match, run_evaluation
from .transform_evaluator import TransformEvaluator

__all__ = ["EvaluationModule", "TransformEvaluator", "greedy_match", "run_evaluation"]
