"""Data parallelism over processes (counterpart of ``emrt_tpu/parallel/mesh.py``;
reference train.py:116-123, val.py:164-170).

The JAX package shards the batch over the ``data`` axis of one mesh and lets
XLA insert the collectives. Here each of N processes (one per GPU, started by
``torchrun --nproc_per_node N``) holds a replica and its own rows of the
global batch: DDP all-reduces the gradients, ``sync_bn.SyncBatchNorm2d``
takes BatchNorm statistics over the global batch, the losses divide by the
global count of kept pixels and ``evaluate`` sums the confusion areas of all
ranks. Without a process group (one process, no ``torchrun``) every function
here answers for one rank and nothing communicates.

Tensor parallelism (``tp_rule``, ``tp_shard_params``, PARALLEL.MODEL) and
spatial sharding (``spatial_batch_sharding``, PARALLEL.SPATIAL) are not
ported: ROADMAP.md queue 1, M12b and M12c.
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


def check_parallel(config, world: int):
    """Refuse a PARALLEL.* layout this port cannot run (the JAX package's
    ``create_mesh`` axes): DATA is -1 (every rank) or the world size;
    MODEL and SPATIAL stay 1."""
    p = config.PARALLEL
    if p.MODEL > 1:
        raise NotImplementedError(
            f"PARALLEL.MODEL {p.MODEL}: tensor parallelism is not ported "
            f"(ROADMAP.md queue 1, M12b)")
    if p.SPATIAL > 1:
        raise NotImplementedError(
            f"PARALLEL.SPATIAL {p.SPATIAL}: spatial sharding is not ported "
            f"(ROADMAP.md queue 1, M12c)")
    if p.DATA not in (-1, world):
        raise ValueError(f"PARALLEL.DATA {p.DATA} does not match the {world} "
                         f"process(es) started (use -1 or {world})")
