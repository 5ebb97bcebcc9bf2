"""Detection evaluation of the port (``main --evaluate``)."""

from .evaluation_module import EvaluationModule, greedy_match, run_evaluation

__all__ = ["EvaluationModule", "greedy_match", "run_evaluation"]
