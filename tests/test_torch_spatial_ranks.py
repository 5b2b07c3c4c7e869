"""The rank-side halves of the spatial-parallel tests (``test_torch_spatial.py``,
``test_torch_spatial_train.py``, ``test_torch_tpsp_train.py``,
``test_torch_spatial_backbones.py``, ``test_torch_spatial_transformers.py``,
``test_torch_spatial_zoo.py``).

Each function runs on every rank of ``emrt_tpu_torch.parallel.launch.run_ranks``
(or in one process, where the world is 1): a spawned child that imports this
module, so the module imports neither JAX nor the JAX package. The ranks are
laid out as ``world / (T * S)`` data ranks by T model ranks by S spatial
ranks (``parallel.mesh.model_parallel(T, S)``): rank r = (d * T + m) * S + s
holds data rank d's rows ``rows(n, d, world / (T * S))`` of a global batch,
and of those images the rows ``[s * H / S, (s + 1) * H / S)``. The module
holds no tests.
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
# HRNet's TF-style "same" 3x3 stride-2 conv (padding (0, 1) over an even
# height, on every rank), the align_corners=False upsamples of its fuse and
# concat (over 8 rows: 4 or 2 a rank), ResNeSt's 3x3 s2 average pool and its
# split attention's global mean with the gate's BatchNorm1d after it
SAME = "same 3x3 s2"
UPSAMPLES = {"upsample x2": 2, "upsample x4": 4, "upsample x8": 8}
GLOBAL_MEAN = "global mean + bn"
# the other ops: the max pool, uphead's 2x resize and the align_corners=True
# resize of a replicated map to the rank's rows (a PSP scale of 3 to 16 rows);
# the others over 32 rows: 16 or 8 a rank
# the transformer backbones' ops on a map whose first row spatial rank 0
# holds alone before its block (ViT's cls token, over 1 + 32 rows): the
# gather of every rank's rows and the dropout whose mask is the whole map's
TOKEN_GATHER, ROW_DROPOUT = "gather, lead 1", "row dropout, lead 1"
OPS = (tuple(name for name, _ in CONVS) + ("max pool", "2x resize", "row resize", SAME)
       + tuple(UPSAMPLES) + ("avg pool", GLOBAL_MEAN, TOKEN_GATHER, ROW_DROPOUT))
# the zoo's (``test_torch_spatial_zoo.py``): the heads' align_corners=True
# upsamples (the MLA head's x4, DPT's x2s) and DPT's readout of spatial rank
# 0's lead token on every rank (over 1 + 32 rows)
UPSAMPLES_AC = {"upsample x2 ac": 2, "upsample x4 ac": 4}
LEAD_TOKENS = "lead tokens"
ZOO_OPS = (*UPSAMPLES_AC, LEAD_TOKENS)
CIN, COUT = 3, 4
# the ops whose input is replicated (each rank holds the whole map) and
# those whose output is (each rank's loss then takes a share of its
# gradient, ``grad_share``)
REPLICATED_IN, REPLICATED_OUT = ("row resize",), (GLOBAL_MEAN, TOKEN_GATHER, LEAD_TOKENS)
LEADS = {TOKEN_GATHER: 1, ROW_DROPOUT: 1, LEAD_TOKENS: 1}


def grad_share(rank: int, world: int) -> float:
    """The share of a replicated output's gradient that rank ``rank``'s loss
    holds: unequal, summing to 1 over the ranks."""
    return (rank + 1) / (world * (world + 1) / 2)


def _op(name, shard=None):
    """The op as a function of its input and weights under ``shard`` (None:
    the whole image)."""
    from emrt_tpu_torch.models.emrt import UpHead
    from emrt_tpu_torch.models.layers import (BatchNorm1d, Conv2dSame, HaloConv2d, RowDropout,
                                              avg_pool_3x3, max_pool_3x3s2, upsample)
    from emrt_tpu_torch.ops.resize import resize_bilinear
    convs = dict(CONVS)
    if name in convs or name == SAME:
        if name == SAME:
            conv = Conv2dSame(CIN, COUT, 3, 2, 0, 1, 1, bias=True)
        else:
            k, st, d, p = convs[name]
            conv = HaloConv2d(CIN, COUT, k, st, p, d, bias=True)
        conv.spatial = shard

        def run(x, w):
            conv.weight, conv.bias = torch.nn.Parameter(w[0]), torch.nn.Parameter(w[1])
            return conv(x), (conv.weight, conv.bias)
        return run
    if name == "max pool":
        return lambda x, w: (max_pool_3x3s2(x, shard) * w[0].view(1, -1, 1, 1), w)
    if name == "2x resize":
        return lambda x, w: (UpHead._up(x * w[0].view(1, -1, 1, 1), shard), w)
    if name in UPSAMPLES or name in UPSAMPLES_AC:
        f, ac = UPSAMPLES.get(name) or UPSAMPLES_AC[name], name in UPSAMPLES_AC
        return lambda x, w: (upsample(x * w[0].view(1, -1, 1, 1),
                                      (f * x.shape[2], f * x.shape[3]), shard, ac), w)
    if name == LEAD_TOKENS:      # the rows as tokens [b, rows, c, w]
        return lambda x, w: ((x[:, :, :1] if shard is None else shard.lead_tokens(
            x.transpose(1, 2), 1).transpose(1, 2)) * w[0].view(1, -1, 1, 1), w)
    if name == "avg pool":
        return lambda x, w: (avg_pool_3x3(x * w[0].view(1, -1, 1, 1), 2, shard), w)
    if name == TOKEN_GATHER:
        return lambda x, w: ((x if shard is None else shard.gather_rows(x, lead=1))
                             * w[0].view(1, -1, 1, 1), w)
    if name == ROW_DROPOUT:
        drop = RowDropout(0.5)
        drop.spatial, drop.lead = shard, 1

        def dropped(x, w):
            torch.manual_seed(0)
            return drop(x * w[0].view(1, -1, 1, 1)), w
        return dropped
    if name == GLOBAL_MEAN:
        bn = BatchNorm1d(CIN, eps=1e-5)

        def gate(x, w):
            bn.weight, bn.bias = torch.nn.Parameter(w[0]), torch.nn.Parameter(w[1])
            gap = x.mean((2, 3)) if shard is None else shard.global_mean(x)
            return bn(gap), (bn.weight, bn.bias)
        return gate

    def row_resize(x, w):
        x = x * w[0].view(1, -1, 1, 1)
        if shard is None:
            return resize_bilinear(x, (16, 12), align_corners=True), w
        return shard.resize_rows(x, (16, 12)), w
    return row_resize


def op_inputs(name, seed=0):
    """The whole input, the weights and the output's upstream gradient of
    ``name`` (float32, from ``seed``)."""
    rng = np.random.default_rng(seed)
    convs = dict(CONVS)
    if name in convs or name == SAME:
        k = convs[name][0] if name in convs else 3
        weights = [rng.normal(size=(COUT, CIN, k, k)), rng.normal(size=(COUT,))]
    elif name == GLOBAL_MEAN:
        weights = [rng.normal(size=(CIN,)) + 2.0, rng.normal(size=(CIN,))]
    else:
        weights = [rng.normal(size=(CIN,)) + 2.0]
    shape = {"row resize": (2, CIN, 3, 3), GLOBAL_MEAN: (4, CIN, 32, 12),
             **{u: (2, CIN, 8, 6) for u in (*UPSAMPLES, *UPSAMPLES_AC)}}.get(
                 name, (2, CIN, 32 + LEADS.get(name, 0), 12))
    x = rng.normal(size=shape)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    with torch.no_grad():
        y, _ = _op(name)(torch.from_numpy(f32(x)), [torch.from_numpy(f32(w)) for w in weights])
    return f32(x), [f32(w) for w in weights], f32(rng.normal(size=tuple(y.shape)))


def run_op(name, x, weights, grad_y, shard=None):
    """The op's output, input gradient and weight gradients, whole or over
    ``shard`` (the input is the rank's rows, or the whole replicated map;
    the output's gradient the rank's rows, or its share of a replicated
    output's)."""
    fn = _op(name, shard)
    lead = LEADS.get(name, 0)

    def own(n):          # the rank's block of n rows, rank 0's with the lead rows
        per = (n - lead) // shard.world
        return slice(0 if shard.rank == 0 else lead + shard.rank * per,
                     lead + (shard.rank + 1) * per)
    if shard is not None and name not in REPLICATED_IN:
        x = x[:, :, own(x.shape[2])]
    xt = torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(True)
    ws = [torch.from_numpy(w).requires_grad_(True) for w in weights]
    y, leaves = fn(xt, ws)
    gy = torch.from_numpy(grad_y)
    if shard is not None:
        gy = (gy * grad_share(shard.rank, shard.world) if name in REPLICATED_OUT
              else gy[:, :, own(gy.shape[2])])
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


# ------------------------------------------------- dp x tp x sp and the backbones

# the EMRTs of ``test_torch_spatial_backbones.py``, seeded: HRNet narrowed
# to ``NARROW_HRNET`` (four branches, strides 4 to 32) and the ResNeSt-50
# (its split-attention gates and 3x3 average pools)
BACKBONES = {"hrnet": "hrnet", "resnest": "resnest50"}
NARROW_HRNET = (8, (1, 1, 1))          # HRNet's width and modules in stages 2-4
# the transformer-backbone EMRTs of ``test_torch_spatial_transformers.py`` at
# crop 64, (backbone, EMRT knobs): CSwin and ViT narrowed as
# ``test_torch_emrt_variants.py`` narrows them (CSwin's splits 1, 2, 7, 7: its
# stage 3's 4 rows and stage 4's 2 padded to one stripe of 7 across both
# ranks; ViT's 4 x 4 patch grid and cls token), the MixViT narrowed to
# ``NARROW_MIT`` (sr ratios 8, 4, 2, 1, a block a stage) and the
# full-width SegFormer-B4 (the JAX step)
TRANSFORMERS = {"cswin": ("CSwinTransformer", dict(trans_embed_dim=32, trans_depths=(1, 1, 1, 1),
                                                   trans_splits=(1, 2, 7, 7))),
                "vit": ("ViT", dict(vit_hidden=64, vit_layers=4, vit_heads=4,
                                    vit_out_indices=(0, 1, 2, 3))),
                "mit": ("segformer_b4", {}), "segformer": ("segformer_b4", {})}
NARROW_MIT = ((16, 32, 40, 64), (1, 1, 1, 1))   # the MixViT's widths and depths
CROP = 64


def _grid_model(kind, state_path, dropout, dtype):
    """The tiny EMRT-R50 from the bridged weights at ``state_path`` (kind
    "r50"), or a BACKBONES or TRANSFORMERS EMRT with 1 encoder and 1 decoder
    layer (HRNet built as ``NARROW_HRNET``, "mit" as ``NARROW_MIT``), or a
    zoo model (kind (its class under ``emrt_tpu_torch.models``, its
    arguments): ``test_torch_zoo.FAMILIES``' narrow ones) from the weights
    at ``state_path``, or from torch's seed 0 where it is None; with dropout
    ``dropout`` (0: DropPath off too)."""
    import contextlib
    import functools
    import importlib
    from unittest import mock

    from emrt_tpu_torch.models import emrt
    from emrt_tpu_torch.models.backbones import mix_transformer
    from emrt_tpu_torch.models.layers import DropPath
    if kind == "r50":
        return _tiny_emrt(state_path, dropout, dtype)
    torch.manual_seed(0)
    backbone, knobs = TRANSFORMERS.get(kind, (BACKBONES.get(kind), {})) if isinstance(
        kind, str) else (None, {})
    with contextlib.ExitStack() as patches:
        patches.enter_context(mock.patch.object(
            emrt, "HRNet", functools.partial(emrt.HRNet, *NARROW_HRNET)))
        if kind == "mit":
            patches.enter_context(mock.patch.dict(mix_transformer._MIT_CONFIGS,
                                                  {"b4": NARROW_MIT}))
        if isinstance(kind, str):
            model = emrt.EMRT(num_classes=NUM_CLASSES, num_encoder_layers=1,
                              num_decoder_layers=1, backbone=backbone, img_size=(CROP, CROP),
                              **knobs).to(dtype)
        else:
            module, name = kind[0].rsplit(".", 1)
            model = getattr(importlib.import_module(f"emrt_tpu_torch.models.{module}"), name)(
                num_classes=NUM_CLASSES, **kind[1]).to(dtype)
    if state_path is not None:
        state = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in torch.load(state_path, weights_only=True).items()}
        missing, unexpected = model.load_state_dict(state, strict=False)
        assert unexpected == [] and all(k.endswith("num_batches_tracked") for k in missing)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = dropout
        if isinstance(m, DropPath) and dropout == 0.0:
            m.rate = 0.0
    return model


def grid_step_rank(rank, world, t, s, kind, state_path, image, label, dropout, fault=None,
                   seed=0, dtype="float32"):
    """One train step of ``_grid_model(kind, ...)`` with the flagship
    config's solver and loss on a grid of ``world / (t * s)`` data ranks by
    ``t`` model ranks by ``s`` spatial ranks, as the train CLI lays it out:
    the model split over its model group, then sharded over its spatial
    group, SyncBatchNorm, DDP over the gradient group (data x spatial of
    equal m) and ``GradientSync`` over the model group, torch seeded from
    (seed, step 1, data rank), the rank's rows of its data rank's images and
    labels. Returns the loss as the train CLI logs it (the gradient group's
    mean), the gradient norm before the clip, the clipped gradients (the
    split ones gathered over the model group), the whole state after the
    step (gathered), this rank's own replicated parameters, the names of
    those read on a head slice (``TP_PARTIAL``) and how many samples the
    step's DropPath layers dropped.

    ``fault`` plants one: "sync over the world", ``GradientSync`` over the
    whole world instead of the model group (the partial gradients summed
    over the spatial ranks again, the clip's split squares too); "gather
    without sum", ``gather_rows``'s backward keeping the rank's rows of its
    own gradient, without the other ranks' parts; "kv gather without sum",
    the same for the gathers of tokens and NHWC rows alone (a transformer
    backbone's keys and values); "sharded bn per rank",
    the sharded region's BatchNorm over the data group only (each rank's
    statistics of its own rows). Two more change the step's form and not
    its value: "full loss", every rank's loss over the whole image (the
    logits gathered, the whole labels; the gather's sum then counts each
    gradient S times, and DDP's mean over the S ranks divides it out), and
    "replicated bn over spatial", the replicated region's BatchNorm over the
    gradient group (its sums and its count n both S times larger). Three
    of a zoo model: "cls on every rank", DPT's readout taking each rank's
    first token (``lead_tokens`` as ``x[:, :lead]``: a patch token off
    spatial rank 0); "class tokens gathered", the mask transformer's
    attentions gathering the class tokens' keys and values with the
    patches' (no ``tail``: each class then counts once a rank); "resize
    over own rows", the heads' resizes over the rank's rows alone
    (``upsample_rows`` as a plain ``resize_bilinear``, which clamps at the
    rank's edges); "windows over own rows", Swin's windows over a map of
    the rank's own rows and zeros for the others' (no neighbour rows and no
    wrap of spatial rank 0's first rows into the last window row); "psp over
    own rows", the UperHead's pyramid-pooling bins pooled over the rank's
    rows and resized to them; "decoder over own tokens", Trans2Seg's
    decoder reading the rank's tokens and zeros for the others'."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.models.layers import DropPath
    from emrt_tpu_torch.parallel import convert_sync_batchnorm
    from emrt_tpu_torch.parallel.mesh import (all_reduce_gradient, data_rank, data_world,
                                              gradient_group, gradient_world, model_group,
                                              model_parallel, model_rank, spatial_group,
                                              spatial_rank)
    from emrt_tpu_torch.parallel.spatial import _GatherRows, shard_model_
    from emrt_tpu_torch.parallel.tensor import (Shard, gather_model_state, join_tensor,
                                                partial_of, shard_of, split_model_, splits_of)
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import make_train_step
    from emrt_tpu_torch.train.cli import spatial_rows, step_seed
    with model_parallel(t, s):
        dtype = getattr(torch, dtype)
        model = _grid_model(kind, state_path, dropout, dtype)
        specs = splits_of(model)
        split_model_(model, model_rank(), t, model_group())
        shard_model_(model, spatial_rank(), s, spatial_group())
        convert_sync_batchnorm(model)
        if fault in ("sharded bn per rank", "replicated bn over spatial"):
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.spatial_stats = fault == "replicated bn over spatial"
        cfg = torch_config.get_config(str(FLAGSHIP))
        optimizer = get_optimizer(cfg, model, get_scheduler(cfg))
        if optimizer.sync is not None:
            optimizer.sync.spread = {}
            if fault == "sync over the world":
                optimizer.sync.shard = Shard(dist.get_rank(), world, None)
        trained = model
        if gradient_world() > 1:
            trained = DistributedDataParallel(
                model, broadcast_buffers=False, process_group=gradient_group(),
                find_unused_parameters=getattr(model, "ddp_find_unused_parameters", False))
        part = rows(len(label), data_rank(), data_world())
        batch = {"image": torch.from_numpy(image[part].transpose(0, 3, 1, 2).copy()).to(dtype),
                 "label": torch.from_numpy(label[part]).long()}
        loss_fn = get_loss_function(cfg)
        if fault == "full loss":
            trained = _GatheredOutputs(trained, model.spatial)
            loss_fn = (lambda fn, whole: lambda out, _: fn(out, whole))(loss_fn, batch["label"])
        sound, zoo = _GatherRows.backward, _zoo_fault(model, fault)
        if fault in ("gather without sum", "kv gather without sum"):
            def unsummed(ctx, g):
                if fault == "gather without sum" or ctx.dim == 1:
                    return _GatherRows.own(ctx, g), None, None, None
                return sound(ctx, g)
            _GatherRows.backward = staticmethod(unsummed)
        dropped = []
        hooks = [m.register_forward_hook(lambda m, _, y: dropped.append(
            int((y.flatten(1) == 0).all(1).sum()))) for m in model.modules()
            if isinstance(m, DropPath) and m.rate > 0]
        step = make_train_step(trained, loss_fn, optimizer)
        torch.manual_seed(step_seed(seed, 1, data_rank(), data_world()))
        try:
            loss = step(spatial_rows(model, batch))
        finally:
            _GatherRows.backward = sound
            zoo.close()
            for h in hooks:
                h.remove()
        loss = all_reduce_gradient(loss.clone()) / gradient_world()
        shard, grads = shard_of(model), {}
        for name, p in model.named_parameters():
            # a parameter no path reads (CSwin's and ViT's tap-0 norm) has none
            g = torch.zeros_like(p) if p.grad is None else p.grad.contiguous()
            if name in specs and shard is not None:
                parts = [torch.empty_like(g) for _ in range(shard.world)]
                dist.all_gather(parts, g, group=shard.group)
                g = join_tensor(parts, specs[name])
            grads[name] = g.numpy().copy()
        state = gather_model_state(model)
        return {"loss": loss.item(), "norm": optimizer.grad_norm.item(), "grads": grads,
                "state": {k: v.numpy().copy() for k, v in state.items()},
                "spread": None if optimizer.sync is None else dict(optimizer.sync.spread),
                "dropped_paths": sum(dropped),
                "partial": sorted(partial_of(model)),
                "replicated": {k: p.detach().numpy().copy()
                               for k, p in model.named_parameters() if k not in specs}}


def _zoo_fault(model, fault):
    """Plant ``grid_step_rank``'s zoo ``fault`` in ``model``; returns the
    patches to close after the step."""
    import contextlib
    from unittest import mock

    from emrt_tpu_torch.models.backbones.vit import Attention
    from emrt_tpu_torch.ops.resize import resize_bilinear
    from emrt_tpu_torch.parallel.spatial import SpatialShard
    patches = contextlib.ExitStack()
    if fault == "cls on every rank":
        patches.enter_context(mock.patch.object(SpatialShard, "lead_tokens",
                                                lambda self, x, lead: x[:, :lead]))
    elif fault == "resize over own rows":
        patches.enter_context(mock.patch.object(
            SpatialShard, "upsample_rows",
            lambda self, x, size, align_corners=False: resize_bilinear(x, size, align_corners)))
    elif fault == "class tokens gathered":
        for m in model.decoder.layers.modules():
            if isinstance(m, Attention):
                m.tail = 0
    elif fault == "windows over own rows":      # UperNet-Swin's only gathers along dim 1
        gather = SpatialShard.gather_rows

        def alone(self, x, dim=2, lead=0):
            if dim % x.dim() != 1:
                return gather(self, x, dim, lead)
            return torch.cat([x if r == self.rank else torch.zeros_like(x)
                              for r in range(self.world)], 1)
        patches.enter_context(mock.patch.object(SpatialShard, "gather_rows", alone))
    elif fault == "psp over own rows":          # UperNet's only gather and cut along dim 2
        gather = SpatialShard.gather_rows
        patches.enter_context(mock.patch.object(
            SpatialShard, "gather_rows", lambda self, x, dim=2, lead=0: (
                x if dim % x.dim() == 2 else gather(self, x, dim, lead))))
        patches.enter_context(mock.patch.object(SpatialShard, "own_rows", lambda self, x: x))
    elif fault == "decoder over own tokens":
        decoder, shard = model.transformer_decoder, model.spatial

        def own_tokens(feat):
            per = feat.shape[1] // shard.world
            keep = torch.zeros_like(feat[:1, :, :1])
            keep[:, shard.rank * per:(shard.rank + 1) * per] = 1
            return type(decoder).forward(decoder, feat * keep)
        patches.enter_context(mock.patch.object(decoder, "forward", own_tokens))
    return patches


def slim_step_rank(rank, world, whole_state, *args):
    """``grid_step_rank(rank, world, *args)`` cut to what the checks of a
    dp x sp step read: no replicated parameters and, without
    ``whole_state``, only the running statistics of the state (a result
    holds every parameter's gradient and state: the suite's workers keep
    less)."""
    out = grid_step_rank(rank, world, *args)
    del out["replicated"]
    if not whole_state:
        out["state"] = {k: v for k, v in out["state"].items() if "running" in k}
    return out


def ohem_rank(rank, world, s, logits, label, min_kept):
    """OHEM (thresh 0.7, ``min_kept``) of the rank's rows of the global
    logits and labels on a grid of ``world / s`` data ranks by ``s``
    spatial ranks: the loss as the train CLI logs it (the gradient group's
    mean), and the gradient of the rank's logits rows."""
    from emrt_tpu_torch.losses import OhemCrossEntropyLoss
    from emrt_tpu_torch.parallel.mesh import (all_reduce_gradient, data_rank, data_world,
                                              gradient_world, model_parallel, spatial_rank)
    with model_parallel(1, s):
        part = rows(len(label), data_rank(), data_world())
        per = label.shape[1] // s
        block = slice(spatial_rank() * per, (spatial_rank() + 1) * per)
        x = torch.from_numpy(logits[part][:, :, block].copy()).requires_grad_(True)
        loss = OhemCrossEntropyLoss(255, thresh=0.7, min_kept=min_kept)(
            [x], torch.from_numpy(label[part][:, block]).long())
        loss.backward()
        logged = all_reduce_gradient(loss.detach().clone()) / gradient_world()
        return {"loss": logged.item(), "grad": x.grad.numpy() / gradient_world()}


def calls_rank(rank, world, calls):
    """``fn(rank, world, *args)`` for each (fn, args) of ``calls`` in turn
    (one start of the ranks for them all)."""
    return [fn(rank, world, *args) for fn, args in calls]
