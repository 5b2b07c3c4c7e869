"""Tensor parallelism over a model group (counterpart of ``tp_rule`` and
``tp_shard_params``, ``emrt_tpu/parallel/mesh.py:54-89``).

The JAX package places the transformer's projections on the mesh's
``model`` axis Megatron-style and lets GSPMD insert the collectives: the
FFN ``linear1`` and the deformable ``value_proj`` column-split, ``linear2``
and ``output_proj`` row-split, and the ``MultiHeadAttention`` q/k/v kernels
and biases and ``out_proj`` split by heads; everything else replicated.
Here each of the T ranks of a model group (``mesh.model_parallel``) holds
its shard of those parameters and runs its part of the layer:

* the rule: a module class that can be split names its split parameters
  in ``TP_SPLITS`` ({name: (torch dim, blocks)}; torch's ``Linear.weight``
  is [out, in], so flax's ``P(None, "model")`` on a kernel is dim 0, and a
  fused q/k/v tensor is 3 blocks, each split by heads), the replicated
  parameters it reads only a head slice of in ``TP_PARTIAL``, and the sizes
  T must divide in ``tp_dims``; ``splits_of(model)`` is the rule over the
  model's parameter names;
* ``split_model_`` cuts a whole model's split parameters to the rank's
  shard in place and gives each such module its ``Shard``
  (``split_for_the_group``: over the CLIs' model group);
  ``shard_state_dict`` / ``gather_state_dict`` do it to state dicts (the
  weight bridge of the tests), ``gather_model_state`` /
  ``gather_optimizer_state`` gather a split model's over its group for a
  checkpoint and ``shard_model_state`` / ``shard_optimizer_state`` split a
  whole one on restore, so a checkpoint holds one process's tensors;
* the conjugate pair of autograd functions: ``Shard.copy_in`` (identity
  forward, model-group all-reduce backward) where a replicated activation
  enters a split region and ``Shard.reduce_out`` (all-reduce forward,
  identity backward) where the partial sums leave it, both in float32;
* ``GradientSync``, the optimizer's step before its clip: the replicated
  parameters read on a head slice get the sum of their gradients over the
  model group, and every other replicated parameter model rank 0's (one
  all-reduce in which the other ranks add zeros), so that replicated
  parameters stay bitwise equal across the world even where a backward
  kernel sums in no fixed order (on CUDA the bilinear resize's and the
  deformable core's value gradient add with atomics); and the global norm
  of the clip, each split tensor's square summed over the group and each
  replicated one counted once. Under spatial parallelism too (tp x sp) DDP
  has already summed every gradient over the gradient group (data x
  spatial of equal model rank), so the gradients ``GradientSync`` reads are
  equal on the ranks of that group, and it and the clip's norm work over
  the model group (the ranks of equal data and spatial rank) alone: each
  spatial rank's part is counted once, in DDP's sum.

Dropout at a split site draws the mask of the full width and keeps the
rank's slice (``models/layers.py::split_dropout``), so a split run draws
the masks one process draws.
"""
from __future__ import annotations

import copy

import torch
import torch.distributed as dist


def _in_float32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32, copy=True)


class _CopyIn(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = _in_float32(grad)
        dist.all_reduce(g, group=ctx.group)
        return g.to(grad.dtype), None


class _ReduceOut(torch.autograd.Function):
    """The partial sums of the model group added, in float32; identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        y = _in_float32(x)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


class Shard:
    """A split module's place in its model group: rank ``rank`` of
    ``world`` over ``group``."""

    def __init__(self, rank: int, world: int, group):
        self.rank, self.world, self.group = rank, world, group

    def rows(self, n: int) -> slice:
        """This rank's block of ``n`` rows split over the group."""
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self.group)

    def reduce_out(self, x: torch.Tensor, bias=None) -> torch.Tensor:
        """The group's sum of the partial products ``x``, plus ``bias``
        once, in x's dtype (summed and biased in float32)."""
        y = _ReduceOut.apply(x, self.group)
        if bias is not None:
            y = y + bias.float()
        return y.to(x.dtype)


def _modules_with(model, attr):
    for prefix, module in model.named_modules():
        if hasattr(type(module), attr):
            yield (f"{prefix}." if prefix else ""), module


def splits_of(model) -> dict:
    """{parameter name: (torch dim, blocks)} of the parameters a model group
    splits: the counterpart of ``tp_rule`` over the port's names."""
    return {prefix + name: spec for prefix, module in _modules_with(model, "TP_SPLITS")
            for name, spec in type(module).TP_SPLITS.items()}


def partial_of(model) -> set:
    """Names of the replicated parameters that a split module reads only a
    head slice of: their gradients are summed over the model group."""
    return {prefix + name for prefix, module in _modules_with(model, "TP_PARTIAL")
            for name in type(module).TP_PARTIAL}


def check_divides(model, world: int):
    """Raise ValueError where ``world`` (PARALLEL.MODEL) does not divide a
    dimension that ``model`` splits (heads, or an FFN's hidden width),
    naming each such dimension once with the first module that has it."""
    uneven = {}
    for prefix, module in _modules_with(model, "TP_SPLITS"):
        for what, n in module.tp_dims().items():
            if n % world:
                uneven.setdefault(f"{n} {what}", prefix.rstrip(".") or type(module).__name__)
    if uneven:
        raise ValueError(f"PARALLEL.MODEL {world} does not divide " + "; ".join(
            f"the {dim} of {where}" for dim, where in uneven.items()))


def shard_tensor(t: torch.Tensor, spec, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s shard of the whole tensor ``t`` under ``spec`` =
    (dim, blocks): along dim, each of the blocks is cut in ``world``."""
    dim, blocks = spec
    shape = t.shape
    n = shape[dim] // (blocks * world)
    view = t.reshape(*shape[:dim], blocks, world, n, *shape[dim + 1:])
    return view.select(dim + 1, rank).reshape(
        *shape[:dim], blocks * n, *shape[dim + 1:]).contiguous()


def join_tensor(shards, spec) -> torch.Tensor:
    """The whole tensor from the shards of every rank, in rank order."""
    dim, blocks = spec
    shape = shards[0].shape
    parts = [s.reshape(*shape[:dim], blocks, shape[dim] // blocks, *shape[dim + 1:])
             for s in shards]
    return torch.stack(parts, dim + 1).reshape(
        *shape[:dim], shape[dim] * len(shards), *shape[dim + 1:])


def shard_state_dict(full: dict, rank: int, world: int, splits: dict) -> dict:
    """Rank ``rank``'s state dict of ``world`` from a whole one."""
    return {k: shard_tensor(v, splits[k], rank, world) if k in splits else v
            for k, v in full.items()}


def gather_state_dict(shards, splits: dict) -> dict:
    """The whole state dict from every rank's, in rank order."""
    return {k: join_tensor([s[k] for s in shards], splits[k]) if k in splits else v
            for k, v in shards[0].items()}


def shard_of(model):
    """The ``Shard`` of a split model, None for a whole one."""
    return next((m.tp for _, m in _modules_with(model, "TP_SPLITS") if m.tp is not None),
                None)


def split_model_(model, rank: int, world: int, group):
    """Cut ``model``'s split parameters (``splits_of``) to rank ``rank``'s
    shard of ``world`` in place, and give each module that splits its
    ``Shard``; the parameters stay the same objects, so do this before an
    optimizer or DDP wraps them. Raises where ``world`` does not divide a
    split dimension. Returns ``model``."""
    check_divides(model, world)
    if world == 1:
        return model
    shard = Shard(rank, world, group)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, spec in splits_of(model).items():
            params[name].data = shard_tensor(params[name].data, spec, rank, world)
    for _, module in _modules_with(model, "TP_SPLITS"):
        module.tp = shard
    return model


def split_for_the_group(config, model):
    """Split ``model`` over this rank's model group (PARALLEL.MODEL ranks of
    ``parallel.mesh.model_parallel``; nothing for 1), as the train and val
    CLIs do; logs the layout. Returns ``model``."""
    from ..utils import logger
    from .mesh import data_world, model_group, model_rank
    t = config.PARALLEL.MODEL
    if t > 1:
        split_model_(model, model_rank(), t, model_group())
        logger.info(f"tensor parallelism: model axis = {t} (data axis = {data_world()})")
    return model


def _all_gather(t: torch.Tensor, shard: Shard, spec) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(shard.world)]
    dist.all_gather(parts, t, group=shard.group)
    return join_tensor(parts, spec)


def gather_model_state(model) -> dict:
    """``model``'s state dict with its split tensors gathered over the model
    group: the one-process state dict (a collective of the group; the
    model's own for a whole model)."""
    state = model.state_dict()
    shard = shard_of(model)
    if shard is None:
        return state
    splits = splits_of(model)
    return {k: _all_gather(v, shard, splits[k]) if k in splits else v
            for k, v in state.items()}


def shard_model_state(model, full: dict) -> dict:
    """A whole state dict cut to ``model``'s shard (as it is for a whole
    model)."""
    shard = shard_of(model)
    if shard is None:
        return full
    return shard_state_dict(full, shard.rank, shard.world, splits_of(model))


def _map_optimizer_state(state: dict, names, fn) -> dict:
    """A copy of a ``_ScheduledOptimizer`` state dict with ``fn(name,
    tensor)`` applied to each per-parameter tensor of its torch optimizer's
    state (momentum, moments; not scalar step counts)."""
    state = copy.copy(state)
    for key, inner in state.items():
        if isinstance(inner, dict) and "state" in inner:
            inner = dict(inner)
            inner["state"] = {i: {k: fn(names[i], v) if torch.is_tensor(v) and v.dim() else v
                                  for k, v in per.items()}
                              for i, per in inner["state"].items()}
            state[key] = inner
    return state


def gather_optimizer_state(optimizer, model) -> dict:
    """``optimizer.state_dict()`` with the state of the split parameters
    gathered over the model group (a collective of the group)."""
    state = optimizer.state_dict()
    shard = shard_of(model)
    if shard is None:
        return state
    splits = splits_of(model)
    return _map_optimizer_state(state, optimizer.names, lambda name, v: _all_gather(
        v, shard, splits[name]) if name in splits else v)


def shard_optimizer_state(optimizer, model, full: dict) -> dict:
    """A one-process optimizer state dict cut to ``model``'s shard."""
    shard = shard_of(model)
    if shard is None:
        return full
    splits = splits_of(model)
    return _map_optimizer_state(full, optimizer.names, lambda name, v: shard_tensor(
        v, splits[name], shard.rank, shard.world) if name in splits else v)


class GradientSync:
    """The model group's part of an optimizer step over a split model.

    Set ``spread`` to a dict to have each ``reduce_`` record there, for
    each replicated parameter given model rank 0's gradient, the largest
    difference over the group between a rank's gradient and rank 0's,
    relative to the largest entry of rank 0's, as it was before the
    overwrite. Rank 0's gradient only breaks the ties of summation order,
    so this stays at rounding level; a gradient that really differs by
    rank (a replicated activation entering a split region without
    ``copy_in``) shows at the size of the other ranks' missing share."""

    spread = None

    def __init__(self, model):
        self.shard = shard_of(model)
        self.splits = set(splits_of(model))
        self.partial = partial_of(model)

    def reduce_(self, names, params):
        """Sum the gradients of the ``TP_PARTIAL`` parameters over the
        model group and give every other replicated parameter model rank
        0's gradient, in one all-reduce."""
        grads = [(n, p.grad) for n, p in zip(names, params)
                 if p.grad is not None and n not in self.splits]
        if not grads:
            return
        flat = torch.cat([(g if n in self.partial or self.shard.rank == 0
                           else torch.zeros_like(g)).reshape(-1) for n, g in grads])
        dist.all_reduce(flat, group=self.shard.group)
        spread = {}
        for (n, g), new in zip(grads, flat.split([g.numel() for _, g in grads])):
            new = new.view_as(g)
            if self.spread is not None and n not in self.partial:
                spread[n] = ((g - new).abs().max().float()
                             / new.abs().max().float().clamp(min=torch.finfo().tiny))
            g.copy_(new)
        if spread:
            values = torch.stack(list(spread.values()))
            dist.all_reduce(values, op=dist.ReduceOp.MAX, group=self.shard.group)
            self.spread.update(zip(spread, values.tolist()))

    def is_split(self, names) -> list:
        return [n in self.splits for n in names]

    def global_norm(self, grads, split) -> torch.Tensor:
        """The L2 norm of the whole model's gradient from this rank's
        ``grads`` (``split`` flags the shards): the shards' squares summed
        over the group, the replicated tensors' counted once."""
        sq = torch.stack(torch._foreach_norm(grads)).float().square()
        flags = torch.tensor(split, device=sq.device)
        split_sq = sq[flags].sum()
        dist.all_reduce(split_sq, group=self.shard.group)
        return (split_sq + sq[~flags].sum()).sqrt()


def gradient_sync(model):
    """A ``GradientSync`` for a split model, None for a whole one."""
    return GradientSync(model) if shard_of(model) is not None else None
