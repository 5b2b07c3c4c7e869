"""The rank-side halves of the spatial-parallel tests (``test_torch_spatial.py``,
``test_torch_spatial_train.py``).

Each function runs on every rank of ``emrt_tpu_torch.parallel.launch.run_ranks``
(or in one process, where the world is 1): a spawned child that imports this
module, so the module imports neither JAX nor the JAX package. The ranks are
laid out as ``world / S`` data ranks by S spatial ranks
(``parallel.mesh.model_parallel(1, S)``): rank r = d * S + s holds data rank
d's rows ``rows(n, d, world / S)`` of a global batch, and of those images
the rows ``[s * H / S, (s + 1) * H / S)``. The module holds no tests.
"""
from __future__ import annotations

import numpy as np
import torch

from emrt_tpu_torch import config as torch_config
from test_torch_parallel_ranks import FLAGSHIP, NUM_CLASSES, rows

torch.set_num_threads(1)

# (name, (kernel, stride, dilation, padding)) of every halo conv of a
# ResNet EMRT's sharded region: the 7x7 stem, the deep stem's and the
# blocks' 3x3 s2, the 3x3s, the dilated 3x3s of output strides 16 and 8,
# the 1x1 s2 downsample and the 1x1s
CONVS = (("7x7 s2", (7, 2, 1, 3)), ("3x3 s2", (3, 2, 1, 1)), ("3x3", (3, 1, 1, 1)),
         ("3x3 d2", (3, 1, 2, 2)), ("3x3 d4", (3, 1, 4, 4)), ("1x1 s2", (1, 2, 1, 0)),
         ("1x1", (1, 1, 1, 0)))
# the other ops: the max pool, uphead's 2x resize and the align_corners=True
# resize of a replicated map to the rank's rows (a PSP scale of 3 to 16 rows);
# the others over 32 rows: 16 or 8 a rank
OPS = tuple(name for name, _ in CONVS) + ("max pool", "2x resize", "row resize")
CIN, COUT = 3, 4


def _op(name, shard=None):
    """(the op as a function of its input and weight, whether its input is
    replicated) under ``shard`` (None: the whole image)."""
    from emrt_tpu_torch.models.emrt import UpHead
    from emrt_tpu_torch.models.layers import HaloConv2d, max_pool_3x3s2
    from emrt_tpu_torch.ops.resize import resize_bilinear
    convs = dict(CONVS)
    if name in convs:
        k, st, d, p = convs[name]
        conv = HaloConv2d(CIN, COUT, k, st, p, d, bias=True)
        conv.spatial = shard

        def run(x, w):
            conv.weight, conv.bias = torch.nn.Parameter(w[0]), torch.nn.Parameter(w[1])
            return conv(x), (conv.weight, conv.bias)
        return run, False
    if name == "max pool":
        return lambda x, w: (max_pool_3x3s2(x, shard) * w[0].view(1, -1, 1, 1), w), False
    if name == "2x resize":
        return lambda x, w: (UpHead._up(x * w[0].view(1, -1, 1, 1), shard), w), False

    def row_resize(x, w):
        x = x * w[0].view(1, -1, 1, 1)
        if shard is None:
            return resize_bilinear(x, (16, 12), align_corners=True), w
        return shard.resize_rows(x, (16, 12)), w
    return row_resize, True


def op_inputs(name, seed=0):
    """The whole input, the weights and the output's upstream gradient of
    ``name`` (float32, from ``seed``)."""
    rng = np.random.default_rng(seed)
    convs = dict(CONVS)
    if name in convs:
        k = convs[name][0]
        weights = [rng.normal(size=(COUT, CIN, k, k)), rng.normal(size=(COUT,))]
    else:
        weights = [rng.normal(size=(CIN,)) + 2.0]
    x = rng.normal(size=(2, CIN, 3, 3) if name == "row resize" else (2, CIN, 32, 12))
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    with torch.no_grad():
        y, _ = _op(name)[0](torch.from_numpy(f32(x)), [torch.from_numpy(f32(w)) for w in weights])
    return f32(x), [f32(w) for w in weights], f32(rng.normal(size=tuple(y.shape)))


def run_op(name, x, weights, grad_y, shard=None):
    """The op's output, input gradient and weight gradients, whole or over
    ``shard`` (the input is the rank's rows, or the whole replicated map)."""
    fn, replicated = _op(name, shard)
    if shard is not None and not replicated:
        x = x[:, :, shard.rows(x.shape[2])]
    xt = torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(True)
    ws = [torch.from_numpy(w).requires_grad_(True) for w in weights]
    y, leaves = fn(xt, ws)
    gy = torch.from_numpy(grad_y)
    if shard is not None:
        gy = gy[:, :, shard.rows(gy.shape[2])]
    y.backward(gy)
    return {"y": y.detach().numpy(), "grad_x": xt.grad.numpy(),
            "grad_w": [w.grad.numpy() for w in leaves]}


def halo_ops_rank(rank, world, cases):
    """Every (name, x, weights, grad_y) of ``cases`` over this rank's
    ``SpatialShard`` of a spatial group of ``world``."""
    from emrt_tpu_torch.parallel.mesh import model_parallel, spatial_group, spatial_rank
    from emrt_tpu_torch.parallel.spatial import SpatialShard
    with model_parallel(1, world):
        shard = SpatialShard(spatial_rank(), world, spatial_group())
        return {name: run_op(name, x, w, gy, shard) for name, x, w, gy in cases}


# ------------------------------------------------------------------ train step

def _tiny_emrt(state_path, dropout, dtype=torch.float32):
    from emrt_tpu_torch.models.emrt import EMRT
    model = EMRT(num_classes=NUM_CLASSES, num_encoder_layers=1, num_decoder_layers=1).to(dtype)
    state = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in torch.load(state_path, weights_only=True).items()}
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert unexpected == [] and all(k.endswith("num_batches_tracked") for k in missing)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = dropout
    return model


class _GatheredOutputs(torch.nn.Module):
    """A sharded model's outputs gathered whole (a planted fault)."""

    def __init__(self, inner, shard):
        super().__init__()
        self.inner, self.shard = inner, shard

    def forward(self, x):
        return [self.shard.gather_rows(o) for o in self.inner(x)]


def sp_train_step_rank(rank, world, s, state_path, image, label, dropout, fault=None, seed=0,
                       dtype="float32"):
    """One step of the tiny EMRT-R50 (1 encoder and 1 decoder layer,
    float32, dropout ``dropout``) from the bridged weights at
    ``state_path`` with the flagship config's solver and loss, on a grid of
    ``world / s`` data ranks by ``s`` spatial ranks as the train CLI lays it
    out: the model sharded over its spatial group, SyncBatchNorm, DDP over
    the gradient group, torch seeded from (seed, step 1, data rank), the
    rank's rows of its data rank's images and labels. Returns the loss as
    the train CLI logs it (the gradient group's mean), the gradient norm
    before the clip, the clipped gradients and the state after the step.

    ``fault`` plants one: "gather without sum", ``gather_rows``'s backward
    keeping the rank's rows of its own gradient, without the other ranks'
    parts; "sharded bn per rank", the sharded region's BatchNorm over the
    data group only (each rank's statistics of its own rows). Two more
    change the step's form and not its value: "full loss", every rank's
    loss over the whole image (the logits gathered, the whole labels; the
    gather's sum then counts each gradient S times, and DDP's mean over the
    S ranks divides it out), and "replicated bn over spatial", the
    replicated region's BatchNorm over the gradient group (its sums and its
    count n both S times larger)."""
    from torch.nn.parallel import DistributedDataParallel

    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.parallel import convert_sync_batchnorm
    from emrt_tpu_torch.parallel.mesh import (all_reduce_gradient, data_rank, data_world,
                                              gradient_group, gradient_world, model_parallel,
                                              spatial_group, spatial_rank)
    from emrt_tpu_torch.parallel.spatial import _GatherRows, shard_model_
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import make_train_step
    from emrt_tpu_torch.train.cli import spatial_rows, step_seed
    sound = _GatherRows.backward
    with model_parallel(1, s):
        dtype = getattr(torch, dtype)
        model = _tiny_emrt(state_path, dropout, dtype)
        shard_model_(model, spatial_rank(), s, spatial_group())
        convert_sync_batchnorm(model)
        bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
        if fault == "sharded bn per rank":
            for m in bns:
                m.spatial_stats = False
        elif fault == "replicated bn over spatial":
            for m in bns:
                m.spatial_stats = True
        cfg = torch_config.get_config(str(FLAGSHIP))
        optimizer = get_optimizer(cfg, model, get_scheduler(cfg))
        trained = model
        if gradient_world() > 1:
            trained = DistributedDataParallel(model, broadcast_buffers=False,
                                              process_group=gradient_group())
        part = rows(len(label), data_rank(), data_world())
        batch = {"image": torch.from_numpy(image[part].transpose(0, 3, 1, 2).copy()).to(dtype),
                 "label": torch.from_numpy(label[part]).long()}
        loss_fn = get_loss_function(cfg)
        if fault == "full loss":
            trained = _GatheredOutputs(trained, model.spatial)
            loss_fn = (lambda fn, whole: lambda out, _: fn(out, whole))(loss_fn, batch["label"])
        if fault == "gather without sum":
            _GatherRows.backward = staticmethod(lambda ctx, g: (
                g.narrow(2, ctx.shard.rank * ctx.rows, ctx.rows), None))
        step = make_train_step(trained, loss_fn, optimizer)
        torch.manual_seed(step_seed(seed, 1, data_rank(), data_world()))
        try:
            loss = step(spatial_rows(model, batch))
        finally:
            _GatherRows.backward = sound
        loss = all_reduce_gradient(loss.clone()) / gradient_world()
        return {"loss": loss.item(), "norm": optimizer.grad_norm.item(),
                "grads": {k: p.grad.numpy().copy() for k, p in model.named_parameters()},
                "state": {k: v.numpy().copy() for k, v in model.state_dict().items()}}


def sp_train_steps_rank(rank, world, calls):
    """``sp_train_step_rank(rank, world, *args)`` for each ``args`` of
    ``calls`` in turn (one start of the ranks for them all)."""
    return [sp_train_step_rank(rank, world, *args) for args in calls]
