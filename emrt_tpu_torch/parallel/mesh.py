"""The process grid of data and tensor parallelism (counterpart of
``emrt_tpu/parallel/mesh.py``; reference train.py:116-123, val.py:164-170).

The JAX package lays its devices out as a ``(data, model, spatial)`` mesh
and lets XLA insert the collectives. Here each of N processes (one per GPU,
started by ``torchrun --nproc_per_node N``) is a rank of that grid with
SPATIAL 1: rank r = d * MODEL + m, the JAX device array's ``reshape(data,
model, spatial)``. The ranks of equal m form a data group, those of equal d
a model group. A data group holds replicas of one shard of the model and
its own rows of the global batch: DDP all-reduces the gradients over it,
``sync_bn.SyncBatchNorm2d`` takes BatchNorm statistics over its global
batch, the losses divide by its global count of kept pixels and
``evaluate`` sums the confusion areas of its ranks. A model group holds one
model split Megatron-style (``parallel/tensor.py``) and loads the same
rows. Without a process group (one process, no ``torchrun``) every
function here answers for one rank and nothing communicates.

Launch: ``torchrun --nproc_per_node 4 -m emrt_tpu_torch.train --config
<yaml> PARALLEL.MODEL 2`` trains dp2 x tp2 (PARALLEL.DATA -1 or 2). On the
CPU the tests run the ranks in processes over gloo
(``tests/test_torch_tensor_parallel*.py``, ``parallel.launch.run_ranks``).
Spatial sharding (``spatial_batch_sharding``, PARALLEL.SPATIAL) is not
ported: ROADMAP.md queue 1, M12c.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist


def is_distributed() -> bool:
    """Whether this process belongs to a process group of more than one rank."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_main() -> bool:
    return rank() == 0


def local_rank() -> int:
    """This process's index among the ranks of its machine (torchrun's
    LOCAL_RANK), which picks its GPU."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def barrier():
    if is_distributed():
        dist.barrier()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place (no gradient); ``t`` as it is
    for one rank."""
    if is_distributed():
        dist.all_reduce(t)
    return t


class _Grid:
    """This rank's place in the (data, model) grid and the groups it joined."""

    def __init__(self, model: int = 1):
        world, r = world_size(), rank()
        self.model_world, self.model_rank = model, r % model
        self.data_world, self.data_rank = world // model, r // model
        self.data_group = self.model_group = None   # None: the whole world, or no group
        self.made = []
        if model == 1:
            return
        # every rank makes every group, in one order
        for d in range(self.data_world):
            g = dist.new_group(list(range(d * model, (d + 1) * model)))
            self.made.append(g)
            if d == self.data_rank:
                self.model_group = g
        if self.data_world > 1:
            for m in range(model):
                g = dist.new_group(list(range(m, world, model)))
                self.made.append(g)
                if m == self.model_rank:
                    self.data_group = g


_grid = None


def _current() -> _Grid:
    return _grid if _grid is not None else _Grid()


def data_rank() -> int:
    """This rank's index in its data group (its shard of the batch)."""
    return _current().data_rank


def data_world() -> int:
    """The ranks of a data group: the replicas of one model shard."""
    return _current().data_world


def model_rank() -> int:
    """This rank's index in its model group (its shard of the model)."""
    return _current().model_rank


def model_world() -> int:
    """PARALLEL.MODEL: the ranks a model is split over."""
    return _current().model_world


def data_group():
    """The process group of this rank's data group (None: the default group)."""
    return _current().data_group


def model_group():
    """The process group of this rank's model group (None where MODEL is 1)."""
    return _current().model_group


def all_reduce_data(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over this rank's data group, in place (no gradient)."""
    if data_world() > 1:
        dist.all_reduce(t, group=data_group())
    return t


@contextlib.contextmanager
def model_parallel(model: int = 1):
    """For the length of a ``with`` block, lay the ranks out as a grid of
    ``world / model`` data ranks by ``model`` model ranks (PARALLEL.MODEL),
    making its groups; they are destroyed on leaving the block. ``model``
    must divide the world (``check_parallel``)."""
    global _grid
    if model < 1 or world_size() % model:
        raise ValueError(f"PARALLEL.MODEL {model} does not divide the {world_size()} "
                         f"process(es) started")
    outer, _grid = _grid, _Grid(model)
    try:
        yield _grid
    finally:
        for g in _grid.made:
            dist.destroy_process_group(g)
        _grid = outer


def local_world_size() -> int:
    """The number of ranks on this process's machine (torchrun's
    LOCAL_WORLD_SIZE)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))


def backend_for(device: torch.device) -> str:
    """``nccl`` where each of the machine's ranks has a GPU of its own;
    ``gloo`` on the CPU, or where the ranks outnumber the GPUs and share
    them (NCCL refuses two ranks on one device)."""
    if device.type == "cuda" and local_world_size() <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


@contextlib.contextmanager
def distributed(device: str | torch.device):
    """For the length of a ``with`` block, join the process group that
    torchrun describes (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT); the block gets the device.

    A process already in a group (a caller that set one up itself, e.g. over
    a file store) keeps it; with WORLD_SIZE 1 or unset no group is created.
    Under more than one rank, ``cuda`` without an index means
    ``cuda:LOCAL_RANK`` (modulo the GPUs, where ranks share them), which
    becomes the current device; the backend is ``backend_for``'s. A group
    made here is destroyed on leaving the block."""
    device = torch.device(device)
    joining = not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1
    if (joining or is_distributed()) and device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if joining:
        dist.init_process_group(backend_for(device))
    try:
        yield device
    finally:
        if joining:
            dist.destroy_process_group()


def build_kernels_once(model, device):
    """Under data parallelism on CUDA, if ``model`` runs the deformable
    kernels: local rank 0 builds (or loads) them while its machine's other
    ranks wait, so that one ``nvcc`` a source runs, not one a rank."""
    from ..models import MSDeformableAttention
    from ..ops import deformable_cuda
    if not (is_distributed() and torch.device(device).type == "cuda" and any(
            isinstance(m, MSDeformableAttention) and m.use_kernel for m in model.modules())):
        return
    if local_rank() == 0:
        deformable_cuda.build()
    dist.barrier()


def check_parallel(config, world: int, model=None):
    """Refuse a PARALLEL.* layout this port cannot run (the JAX package's
    ``create_mesh`` axes): SPATIAL stays 1; MODEL divides the world, and
    DATA is -1 or world / MODEL. Given the model, MODEL must also divide
    every dimension it splits (``tensor.check_divides``), as JAX's
    ``device_put`` refuses an uneven split."""
    p = config.PARALLEL
    if p.SPATIAL > 1:
        raise NotImplementedError(
            f"PARALLEL.SPATIAL {p.SPATIAL}: spatial sharding is not ported "
            f"(ROADMAP.md queue 1, M12c)")
    if p.MODEL < 1 or world % p.MODEL:
        raise ValueError(f"PARALLEL.MODEL {p.MODEL} does not divide the {world} "
                         f"process(es) started")
    if p.DATA not in (-1, world // p.MODEL):
        raise ValueError(f"PARALLEL.DATA {p.DATA} x PARALLEL.MODEL {p.MODEL} does not "
                         f"match the {world} process(es) started (use -1 or "
                         f"{world // p.MODEL})")
    if model is not None:
        from .tensor import check_divides
        check_divides(model, p.MODEL)
