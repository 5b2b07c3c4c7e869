"""The process grid of data, tensor and spatial parallelism (counterpart of
``emrt_tpu/parallel/mesh.py``; reference train.py:116-123, val.py:164-170).

The JAX package lays its devices out as a ``(data, model, spatial)`` mesh
and lets XLA insert the collectives. Here each of N processes (one per GPU,
started by ``torchrun --nproc_per_node N``) is a rank of that grid: rank r =
(d * MODEL + m) * SPATIAL + s, the JAX device array's ``reshape(data,
model, spatial)``. The ranks of equal (m, s) form a data group, those of
equal (d, s) a model group, those of equal (d, m) a spatial group, and
those of equal m a gradient group (data x spatial). A data group holds
replicas of one shard of the model and its own rows of the global batch:
the loader shards the batch over it, the replicated region's BatchNorm
(``sync_bn.SyncBatchNorm2d``) takes its statistics over its global batch
and ``evaluate`` sums the confusion areas of its ranks. A model group holds
one model split Megatron-style (``parallel/tensor.py``) and loads the same
rows. A spatial group loads the same rows too, and each of its ranks trains
on its block of the image rows (``parallel/spatial.py``). A gradient group
is what DDP all-reduces the gradients over and what the losses count kept
pixels over: with SPATIAL 1 it is the data group. Without a process group
(one process, no ``torchrun``) every function here answers for one rank and
nothing communicates.

Launch: ``torchrun --nproc_per_node 4 -m emrt_tpu_torch.train --config
<yaml> PARALLEL.MODEL 2`` trains dp2 x tp2 (PARALLEL.DATA -1 or 2);
``... --nproc_per_node 2 ... PARALLEL.SPATIAL 2`` trains dp1 x sp2 (an
EMRT with any backbone: ResNet, ResNeXt, ResNeSt, HRNet, CSwin, ViT or
SegFormer-B4) and
``... --nproc_per_node 4 ... PARALLEL.MODEL 2 PARALLEL.SPATIAL 2`` dp1 x
tp2 x sp2: the split transformer runs on the maps each spatial group
gathers, DDP sums the gradients over the gradient group and the
optimizer's ``GradientSync`` then works over the model group alone. On the
CPU the tests run the ranks in processes over gloo
(``tests/test_torch_{tensor_parallel,spatial,tpsp}*.py``,
``parallel.launch.run_ranks``).
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
    """This rank's place in the (data, model, spatial) grid and the groups it
    joined (None for a group of one rank, and for a data or gradient group
    that is the whole world: the default group)."""

    def __init__(self, model: int = 1, spatial: int = 1):
        world, r = world_size(), rank()
        self.model_world, self.spatial_world = model, spatial
        self.data_world = world // (model * spatial)
        self.spatial_rank = r % spatial
        self.model_rank = r // spatial % model
        self.data_rank = r // (spatial * model)
        self.gradient_world = self.data_world * spatial
        self.gradient_rank = self.data_rank * spatial + self.spatial_rank
        self.data_group = self.model_group = self.spatial_group = self.gradient_group = None
        self.made = []
        if model == spatial == 1:
            return

        def at(d, m, s):
            return (d * model + m) * spatial + s

        def make(lists, mine):
            # every rank makes every group, in one order
            for ranks in lists:
                g = dist.new_group(ranks)
                self.made.append(g)
                if mine in ranks:
                    yield g

        D, M, S = self.data_world, model, spatial
        if M > 1:
            self.model_group, = make([[at(d, m, s) for m in range(M)]
                                      for d in range(D) for s in range(S)], r)
        if S > 1:   # a group of its own even where it is the world
            self.spatial_group, = make([[at(d, m, s) for s in range(S)]
                                        for d in range(D) for m in range(M)], r)
        if D > 1:
            self.data_group, = make([[at(d, m, s) for d in range(D)]
                                     for m in range(M) for s in range(S)], r)
        if M > 1 and S > 1:
            self.gradient_group, = make([[at(d, m, s) for d in range(D) for s in range(S)]
                                         for m in range(M)], r)
        elif M > 1:
            self.gradient_group = self.data_group


_grid = None


def _current() -> _Grid:
    return _grid if _grid is not None else _Grid()


def data_rank() -> int:
    """This rank's index in its data group (its shard of the batch)."""
    return _current().data_rank


def data_world() -> int:
    """The ranks of a data group: the replicas of one model shard that load
    other rows."""
    return _current().data_world


def model_rank() -> int:
    """This rank's index in its model group (its shard of the model)."""
    return _current().model_rank


def model_world() -> int:
    """PARALLEL.MODEL: the ranks a model is split over."""
    return _current().model_world


def spatial_rank() -> int:
    """This rank's index in its spatial group (its block of the image rows)."""
    return _current().spatial_rank


def spatial_world() -> int:
    """PARALLEL.SPATIAL: the ranks an image's rows are split over."""
    return _current().spatial_world


def gradient_world() -> int:
    """The ranks of a gradient group (data x spatial): those whose parameter
    gradients are parts of one sum."""
    return _current().gradient_world


def gradient_rank() -> int:
    """This rank's index in its gradient group (d * SPATIAL + s): the place
    of its rows in the group's flat batch."""
    return _current().gradient_rank


def data_group():
    """The process group of this rank's data group (None: the default group)."""
    return _current().data_group


def model_group():
    """The process group of this rank's model group (None where MODEL is 1)."""
    return _current().model_group


def spatial_group():
    """The process group of this rank's spatial group (None where SPATIAL is 1)."""
    return _current().spatial_group


def gradient_group():
    """The process group of this rank's gradient group (None: the default
    group)."""
    return _current().gradient_group


def all_reduce_data(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over this rank's data group, in place (no gradient)."""
    if data_world() > 1:
        dist.all_reduce(t, group=data_group())
    return t


def all_reduce_gradient(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over this rank's gradient group, in place (no gradient)."""
    if gradient_world() > 1:
        dist.all_reduce(t, group=gradient_group())
    return t


@contextlib.contextmanager
def model_parallel(model: int = 1, spatial: int = 1):
    """For the length of a ``with`` block, lay the ranks out as a grid of
    ``world / (model * spatial)`` data ranks by ``model`` model ranks
    (PARALLEL.MODEL) by ``spatial`` spatial ranks (PARALLEL.SPATIAL),
    making its groups; they are destroyed on leaving the block. ``model *
    spatial`` must divide the world (``check_parallel``)."""
    global _grid
    if model < 1 or world_size() % model:
        raise ValueError(f"PARALLEL.MODEL {model} does not divide the {world_size()} "
                         f"process(es) started")
    if spatial < 1 or world_size() % (model * spatial):
        raise ValueError(f"PARALLEL.SPATIAL {spatial} x PARALLEL.MODEL {model} does not "
                         f"divide the {world_size()} process(es) started")
    outer, _grid = _grid, _Grid(model, spatial)
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
    ``create_mesh`` axes): MODEL x SPATIAL divides the world, DATA is -1 or
    world / (MODEL x SPATIAL). Given the model, MODEL must also divide every
    dimension it splits (``tensor.check_divides``), as JAX's ``device_put``
    refuses an uneven split, and SPATIAL must fit it
    (``spatial.check_spatial``: an EMRT, of any backbone, whose deepest
    sharded rows SPATIAL divides, each rank's at least as many as the
    deepest halo there; not the zoo)."""
    p = config.PARALLEL
    if p.MODEL < 1 or world % p.MODEL:
        raise ValueError(f"PARALLEL.MODEL {p.MODEL} does not divide the {world} "
                         f"process(es) started")
    if p.SPATIAL < 1 or world % (p.MODEL * p.SPATIAL):
        raise ValueError(f"PARALLEL.SPATIAL {p.SPATIAL} x PARALLEL.MODEL {p.MODEL} does "
                         f"not divide the {world} process(es) started")
    n_data = world // (p.MODEL * p.SPATIAL)
    if p.DATA not in (-1, n_data):
        raise ValueError(f"PARALLEL.DATA {p.DATA} x PARALLEL.MODEL {p.MODEL} x "
                         f"PARALLEL.SPATIAL {p.SPATIAL} does not match the {world} "
                         f"process(es) started (use -1 or {n_data})")
    if model is not None:
        from .tensor import check_divides
        check_divides(model, p.MODEL)
        if p.SPATIAL > 1:
            from .spatial import check_spatial
            check_spatial(model, p.SPATIAL, int(config.DATA.CROP_SIZE[1]))
