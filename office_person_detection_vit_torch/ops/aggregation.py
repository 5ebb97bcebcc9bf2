"""Zone-count aggregation on tensors.

Mirrors ``zone_count_matrix`` and ``unclassified_counts`` of
``office_person_detection_vit_tpu/ops/aggregation.py``.
"""

from __future__ import annotations

import torch


def zone_count_matrix(membership: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(F, Q, Z) bool membership x (F, Q) bool valid -> (F, Z) int32 counts;
    a detection inside several zones counts once in each."""
    return (membership & valid[..., None]).sum(dim=1, dtype=torch.int32)


def unclassified_counts(membership: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(F, Q, Z), (F, Q) -> (F,) int32 number of valid detections in no zone."""
    return (~membership.any(dim=-1) & valid).sum(dim=-1, dtype=torch.int32)
