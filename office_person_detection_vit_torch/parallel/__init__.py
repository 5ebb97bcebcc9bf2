"""Scale-out on ``torch.distributed``: the (data, model) grid of ranks, the
tensor-parallel rules and layers, and data-parallel detection.

Mirrors ``office_person_detection_vit_tpu/parallel/__init__.py``.
"""

from .inference import make_sharded_detect
from .mesh import DATA_AXIS, MODEL_AXIS, batch_sharding, make_mesh, replicated
from .sharding import param_specs, shard_params

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_sharding",
    "make_mesh",
    "make_sharded_detect",
    "param_specs",
    "replicated",
    "shard_params",
]
