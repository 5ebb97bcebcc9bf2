"""The (data, model) grid of ranks, on ``torch.distributed``.

Mirrors ``office_person_detection_vit_tpu/parallel/mesh.py``: ``make_mesh``
(:30) lays the ranks out as JAX lays its devices, ``reshape(data, model)``,
so rank r sits at data index r // model and model index r % model; it raises
where ``model_parallel`` does not divide the number of ranks, and one process
degrades to 1x1. One process drives one card (``torchrun``), so a rank is
JAX's device. ``initialize_distributed`` (:59) starts the process group
(NCCL on the card, gloo on the CPU), and does nothing in a single-process
environment or where a group already runs. ``batch_sharding`` and
``replicated`` (:85-90) become rank-slicing helpers: a rank's slice of the
frame or batch axis, and the whole tensor.

Collectives are explicit: :class:`DataGroup` all-reduces sums (the
positive and box counts of a loss, the gradients) over the ranks that hold
the same model shard, and ``parallel/sharding.py`` all-reduces the
row-parallel layers over the ranks of one model group.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"


def world() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


@dataclasses.dataclass
class DataGroup:
    """The ranks that hold one model shard and split the batch: ``index`` of
    ``size``. A single rank (``group`` None) reduces nothing."""

    index: int
    size: int
    group: object | None

    def local(self, batch: dict) -> dict:
        """This rank's slice of every tensor's leading (batch) axis."""
        return {k: batch_slice(v, self.index, self.size) for k, v in batch.items()}

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data ranks (a new tensor)."""
        t = t.detach().clone()
        return t if self.group is None else _sum(t, self.group)

    def all_sum_(self, tensors: list[torch.Tensor]) -> None:
        """Sum each tensor over the data ranks, in place."""
        if self.group is None:
            return
        for t in tensors:
            _sum(t, self.group)


@dataclasses.dataclass
class Mesh:
    """This rank's place on the (data, model) grid and the groups along its
    two axes (None where an axis has size 1)."""

    data_parallel: int
    model_parallel: int
    rank: int
    data_group_handle: object | None
    model_group: object | None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data_parallel, MODEL_AXIS: self.model_parallel}

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallel

    def data_group(self) -> DataGroup:
        return DataGroup(self.data_index, self.data_parallel, self.data_group_handle)


def make_mesh(n_devices: int | None = None, model_parallel: int = 1) -> Mesh:
    """(data, model) grid over ``n_devices`` ranks (default: the process
    group's world size, 1 without one). ``model_parallel`` must divide it;
    the data axis gets the rest. With more than one rank every rank of the
    group must call this, in the same order (it creates the groups)."""
    rank, size = world()
    if n_devices is None:
        n_devices = size
    if n_devices % model_parallel != 0:
        raise ValueError(f"model_parallel={model_parallel} must divide n_devices={n_devices}")
    if n_devices != size:
        raise ValueError(f"a mesh of {n_devices} ranks needs a process group of {n_devices}; this one has {size}")
    data_parallel = n_devices // model_parallel
    data_handle = model_handle = None
    if n_devices > 1:
        for m in range(model_parallel):  # every rank creates every group, in one order
            g = dist.new_group([d * model_parallel + m for d in range(data_parallel)])
            if rank % model_parallel == m:
                data_handle = g
        for d in range(data_parallel):
            g = dist.new_group([d * model_parallel + m for m in range(model_parallel)])
            if rank // model_parallel == d:
                model_handle = g
    logger.info("mesh: %d ranks as (%s=%d, %s=%d)", n_devices, DATA_AXIS, data_parallel, MODEL_AXIS,
                model_parallel)
    return Mesh(data_parallel, model_parallel, rank,
                data_handle if data_parallel > 1 else None, model_handle if model_parallel > 1 else None)


def initialize_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, backend: str | None = None) -> None:
    """Start the process group: ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id`` as given, else from the
    environment ``torchrun`` sets (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). NCCL where a card is present (this process
    takes card ``LOCAL_RANK``), gloo otherwise. A single-process environment
    (nothing given, no ``WORLD_SIZE``) and a group that already runs are
    left as they are, as JAX's ``initialize_distributed`` skips them."""
    if dist.is_initialized():
        logger.debug("torch.distributed already initialized; skipped")
        return
    if num_processes is None and "WORLD_SIZE" not in os.environ:
        logger.debug("single-process environment; torch.distributed not initialized")
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id or 0)) % torch.cuda.device_count())
    kw = {}
    if coordinator_address is not None:
        kw["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group(backend, **kw)
    logger.info("torch.distributed initialized (%s): process %d/%d", backend, dist.get_rank(),
                dist.get_world_size())


def detect_mesh(data_parallel: int, model_parallel: int, batch_size: int) -> tuple[Mesh | None, int, int]:
    """The detectors' grid (JAX ``DETRDetector._setup_mesh``): over the
    process group's ranks, one card each, with ``data_parallel`` -1 for all
    of them -> (mesh, data axis, the batch size rounded up to a multiple of
    it). None (and 1) for one rank, or for a grid the group does not match
    (with a warning). Every rank of the group must call it."""
    n = world()[1]
    mp = max(1, model_parallel)
    dp = max(1, n // mp) if data_parallel == -1 else data_parallel
    if dp * mp <= 1:
        return None, 1, batch_size
    if dp * mp != n:
        logger.warning("parallel config wants %d ranks but the process group has %d; one device", dp * mp, n)
        return None, 1, batch_size
    if batch_size % dp:
        aligned = -(-batch_size // dp) * dp
        logger.info("batch_size %d -> %d (multiple of data axis %d)", batch_size, aligned, dp)
        batch_size = aligned
    return make_mesh(dp * mp, model_parallel=mp), dp, batch_size


def batch_slice(t: torch.Tensor, index: int, size: int) -> torch.Tensor:
    """Slice ``index`` of ``size`` equal slices of the leading axis (which
    ``size`` must divide): JAX's ``P(DATA_AXIS)`` placement, by hand."""
    n = t.shape[0]
    if n % size:
        raise ValueError(f"a leading axis of {n} does not split over {size} data ranks")
    step = n // size
    return t[index * step:(index + 1) * step]


def batch_sharding(mesh: Mesh):
    """The frame-batch placement: a function giving this rank's slice."""
    return lambda t: batch_slice(t, mesh.data_index, mesh.data_parallel)


def replicated(mesh: Mesh):
    """The replicated placement: every rank holds the whole tensor."""
    return lambda t: t
