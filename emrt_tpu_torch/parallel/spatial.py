"""Spatial parallelism over a spatial group (counterpart of
``spatial_batch_sharding``, ``emrt_tpu/parallel/mesh.py:34-44``: the train
batch placed on ``P("data", "spatial")``, image H split over the mesh's
``spatial`` axis, GSPMD inserting the conv halo exchanges and the gathers).

PyTorch has no such pass, so the exchanges are written here by hand. Rank s
of a spatial group of S (``mesh.model_parallel``) holds the rows ``[s * H /
S, (s + 1) * H / S)`` of its data rank's images and labels, and of every
map of the sharded region of an EMRT with a convolutional backbone
(``models/emrt.py``: a ResNet, ResNeXt, ResNeSt or HRNet): the backbone
(HRNet's four branches at strides 4 to 32 and its ``input_proj``), the
spatial branch, the aux FCN head, ``cls_psp`` and ``uphead``. What crosses
the region's edges:

* ``SpatialShard.window`` / ``halo``: a conv of kernel k, stride st,
  dilation d and top padding p over local rows divisible by st reads ``p``
  rows above and ``max(0, (k - 1) d - p - (st - 1))`` below
  (``models/layers.halo_rows``); the neighbours' edge rows are exchanged
  (one all-gather of every rank's edge rows over the group: the edges are
  small, and a collective of the whole group cannot deadlock), and at the
  image's global top and bottom the op's own padding comes in: zeros for a
  conv or a padding-counting average pool, -inf for a max pool, the edge
  row for a bilinear resize. The backward sends each halo row's gradient
  back to its owner, who adds it into its edge rows. A conv or pool runs
  over the rank's rows with its own padding and recomputes from thin
  strips only the rows that read a halo, so that it keeps no padded copy
  of its input for the backward. A TF-style "same" conv
  (``layers.Conv2dSame``) takes its top padding from the image's global
  height: (0, 1) for k 3 and stride 2 over an even height, so it reads no
  row above and one below, on every rank (a rank's own "same" padding
  would read a zero row where its neighbour's first row belongs);
* ``SpatialShard.upsample_rows``: the rank's rows of an align_corners=False
  bilinear upsample by an integer factor of a sharded map (HRNet's fuse
  and its stages' concat, x2 to x8), each output row from the source rows
  ``floor((y + 0.5) / f - 0.5)`` and the next of the global frame, clipped
  at the image's edges: one halo row each side;
* ``SpatialShard.global_mean``: the mean over the whole image of a sharded
  map, replicated on every rank (ResNeSt's split-attention gate): its
  forward all-reduces the ranks' partial sums, its backward the incoming
  gradients (each rank's loss sees only its rows' part of the gate's
  effect) and spreads the sum over the rank's rows;
* ``SpatialShard.gather_rows``: the whole map, every rank's rows in order,
  for the replicated region (the pyramid pooling, the deformable
  encoder-decoder with K1-K3 at the full token count, EFP). Its backward
  sums the gradient over the group and keeps the rank's rows: each rank's
  loss covers only its own rows (``losses/cross_entropy.py``), so the
  replicated region's gradient on a rank is its rows' part, and the sum of
  the parts is the whole;
* ``SpatialShard.own_rows``: a replicated map cut to the rank's rows
  (backward: zeros elsewhere), and ``resize_rows``, an align_corners=True
  bilinear resize of a replicated map that computes only the rank's
  output rows, each from the source row ``y (in - 1) / (out - 1)`` of the
  global frame;
* dropout in the sharded region draws the full-height mask, as one process
  draws it, and keeps the rank's rows (``models/layers.split_dropout``).

Every collective runs in float32 at least (exact for the forward's copies). The
modules keep their weights, names and state-dict keys: ``shard_model_``
gives each module of the sharded region the rank's ``SpatialShard``, which
only changes how it runs in training mode; in eval mode the whole model runs
on every rank, as the JAX package evaluates (data-sharded only). Under
tensor parallelism too (PARALLEL.MODEL > 1) each rank of a model group
shards its rows alike: the split transformer runs on the maps its spatial
group gathered.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A float32 (float64 for float64) copy of ``t``, what the collectives
    carry."""
    return t.to(torch.promote_types(t.dtype, torch.float32), copy=True)


def _all_gather(t: torch.Tensor, group, world: int) -> list:
    t = _wide(t).contiguous()
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t, group=group)
    return parts


def _pad_rows(x, n: int, mode: str, top: bool) -> torch.Tensor:
    shape = (*x.shape[:2], n, x.shape[3])
    if mode == "zeros":
        return x.new_zeros(shape)
    if mode == "-inf":
        return x.new_full(shape, float("-inf"))
    edge = x[:, :, :1] if top else x[:, :, -1:]
    return edge.expand(shape)


class _Halo(torch.autograd.Function):
    """(the ``top`` last rows of the rank above, the ``bottom`` first rows of
    the rank below) of ``x``, the op's padding ``mode`` beyond the image's
    global edges; backward: each halo row's gradient added into its owner's
    edge row."""

    @staticmethod
    def forward(ctx, x, top, bottom, mode, shard):
        ctx.top, ctx.bottom, ctx.mode, ctx.shard = top, bottom, mode, shard
        s, n = shard.rank, shard.world
        # each rank's first ``bottom`` rows (the halo of the rank above) and
        # last ``top`` rows (the halo of the rank below)
        parts = _all_gather(torch.cat([x[:, :, :bottom], x[:, :, x.shape[2] - top:]], 2),
                            shard.group, n)
        above = (parts[s - 1][:, :, bottom:].to(x.dtype) if s > 0
                 else _pad_rows(x, top, mode, True))
        below = (parts[s + 1][:, :, :bottom].to(x.dtype) if s < n - 1
                 else _pad_rows(x, bottom, mode, False))
        ctx.shape = x.shape
        return above, below

    @staticmethod
    def backward(ctx, g_top, g_bot):
        top, bottom, mode, shard = ctx.top, ctx.bottom, ctx.mode, ctx.shard
        s, n = shard.rank, shard.world
        parts = _all_gather(torch.cat([g_top, g_bot], 2), shard.group, n)
        g = g_top.new_zeros(ctx.shape, dtype=parts[0].dtype)
        rows = ctx.shape[2]
        if s < n - 1:    # the rank below read my last ``top`` rows
            g[:, :, rows - top:] += parts[s + 1][:, :, :top]
        elif mode == "edge":
            g[:, :, -1:] += g_bot.to(g.dtype).sum(2, keepdim=True)
        if s > 0:        # the rank above read my first ``bottom`` rows
            g[:, :, :bottom] += parts[s - 1][:, :, top:]
        elif mode == "edge":
            g[:, :, :1] += g_top.to(g.dtype).sum(2, keepdim=True)
        return g.to(g_top.dtype), None, None, None, None


class _GatherRows(torch.autograd.Function):
    """Every rank's rows in order (dim 2); backward: the gradient summed over
    the group, the rank's rows kept."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard, ctx.rows = shard, x.shape[2]
        return torch.cat(_all_gather(x, shard.group, shard.world), 2).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        g = _wide(grad)
        dist.all_reduce(g, group=ctx.shard.group)
        return g.narrow(2, ctx.shard.rank * ctx.rows, ctx.rows).to(grad.dtype), None


class _GlobalMean(torch.autograd.Function):
    """The mean over the image's H x W of every rank's rows, replicated;
    backward: the gradients of the ranks summed, spread evenly over the
    rank's rows."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shape, ctx.shard = x.shape, shard
        total = _wide(x.sum((2, 3), dtype=torch.promote_types(x.dtype, torch.float32)))
        dist.all_reduce(total, group=shard.group)
        return (total / (x.shape[2] * shard.world * x.shape[3])).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        n, c, rows, w = ctx.shape
        g = _wide(grad)
        dist.all_reduce(g, group=ctx.shard.group)
        g = g / (rows * ctx.shard.world * w)
        return g.to(grad.dtype)[:, :, None, None].expand(n, c, rows, w), None


class SpatialShard:
    """A sharded module's place in its spatial group: rank ``rank`` of
    ``world`` over ``group``, holding the ``rows(n)`` block of a map of n
    rows. ``world`` and ``rank`` also serve ``layers.split_dropout``."""

    def __init__(self, rank: int, world: int, group):
        self.rank, self.world, self.group = rank, world, group

    def rows(self, n: int) -> slice:
        """This rank's block of a map of ``n`` rows (n divisible by world)."""
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def _halos(self, x, top: int, bottom: int, mode: str):
        if max(top, bottom) > x.shape[2]:
            raise ValueError(f"a halo of {max(top, bottom)} rows is deeper than the "
                             f"{x.shape[2]} rows of a rank (PARALLEL.SPATIAL {self.world})")
        return _Halo.apply(x, top, bottom, mode, self)

    def halo(self, x, top: int, bottom: int, mode: str = "zeros") -> torch.Tensor:
        """``x`` (this rank's rows, NCHW) with ``top`` rows above and ``bottom``
        below from the neighbours, or ``mode`` padding ("zeros", "-inf",
        "edge") at the image's global edges."""
        if top == bottom == 0:
            return x
        above, below = self._halos(x, top, bottom, mode)
        return torch.cat([above, x, below], 2)

    def window(self, x, op, kernel: int, stride: int, dilation: int, padding,
               mode: str = "zeros") -> torch.Tensor:
        """This rank's output rows of a window op over the image's rows (a
        conv or a pool of ``kernel``, ``stride``, ``dilation`` and H
        ``padding``, an int or (top, bottom), whose padding value is
        ``mode``'s). ``op(t, (top, bottom))`` runs it over ``t`` with that
        H padding. The op runs over the
        rank's rows with its own padding, which is right at the image's
        edges and for every output row that reads only the rank's rows;
        the rows that read a neighbour's are then computed again from thin
        strips with the halos (``layers.halo_rows``). So the op saves the
        input that the layer before it saves, as in one process, not a
        padded copy of it."""
        from ..models.layers import halo_rows
        pad = (padding, padding) if isinstance(padding, int) else tuple(padding)
        p = pad[0]
        top, bottom = halo_rows(kernel, stride, dilation, p)
        y = op(x, pad)
        rows, out = x.shape[2], y.shape[2]
        reach = (kernel - 1) * dilation
        n_top = -(-p // stride)                                 # rows that read above
        n_bottom = out - 1 - (rows - 1 + p - reach) // stride   # ... and below
        if n_top == n_bottom == 0:
            return y
        above, below = self._halos(x, top, bottom, mode)
        end = (n_top - 1) * stride - p + reach + 1   # the rows the top ones read
        start = (out - n_bottom) * stride - p         # ... and the bottom ones
        if n_top + n_bottom >= out or end > rows or start < 0:
            return op(torch.cat([above, x, below], 2), (0, 0))   # every row reads a halo
        # at the image's edges the halos are the op's padding: the strips give
        # the same rows, and every rank's backward reaches the exchange
        parts = [y[:, :, n_top:out - n_bottom]]
        if n_top:
            parts.insert(0, op(torch.cat([above, x[:, :, :end]], 2), (0, 0)))
        if n_bottom:
            parts.append(op(torch.cat([x[:, :, start:], below], 2), (0, 0)))
        return torch.cat(parts, 2)

    def gather_rows(self, x) -> torch.Tensor:
        """The whole map from every rank's rows (a collective of the group)."""
        return _GatherRows.apply(x, self)

    def own_rows(self, x) -> torch.Tensor:
        """This rank's rows of a replicated map (backward: zeros elsewhere)."""
        return x[:, :, self.rows(x.shape[2])]

    def resize_rows(self, x, size, align_corners: bool = True) -> torch.Tensor:
        """This rank's rows of ``resize_bilinear(x, size, align_corners=True)``
        of a replicated ``x``, computing only them: output row y (global)
        interpolates source rows floor(y * scale) and the next, scale = (in
        - 1) / (out - 1); the columns then go through ``F.interpolate`` at
        the rows' own height (an identity along H)."""
        if not align_corners:
            raise NotImplementedError("resize_rows takes align_corners=True")
        out_h, out_w = int(size[0]), int(size[1])
        in_h = x.shape[2]
        part = self.rows(out_h)
        y = torch.arange(part.start, part.stop, device=x.device, dtype=torch.float32)
        src = y * ((in_h - 1) / (out_h - 1) if out_h > 1 else 0.0)
        lo = src.floor().long().clamp(max=in_h - 1)
        hi = (lo + 1).clamp(max=in_h - 1)
        w_hi = (src - lo).view(1, 1, -1, 1)
        w_hi = w_hi.to(torch.promote_types(x.dtype, torch.float32))
        rows = (x[:, :, lo] * (1 - w_hi) + x[:, :, hi] * w_hi).to(x.dtype)
        return F.interpolate(rows, size=(rows.shape[2], out_w), mode="bilinear",
                             align_corners=True)

    def upsample_rows(self, x, size) -> torch.Tensor:
        """This rank's rows of ``resize_bilinear(x, size)`` (align_corners
        False) of the sharded map ``x`` upsampled by an integer factor f
        along H, ``size`` the rank's (rows, columns) of the output. Output
        row y (global) interpolates source rows floor(src) and the next,
        src = max((y + 0.5) / f - 0.5, 0), the next clipped at the image's
        last row (torch's and the JAX package's rule): one row of each
        neighbour (``halo``, the edge row at the image's edges). The
        columns then go through ``F.interpolate`` at the rows' own height
        (an identity along H)."""
        rows, out_h, out_w = x.shape[2], int(size[0]), int(size[1])
        if out_h % rows:
            raise ValueError(f"upsample_rows: {out_h} rows are not an integer factor of {rows}")
        factor = out_h // rows
        first = self.rank * rows
        y = torch.arange(self.rank * out_h, (self.rank + 1) * out_h, device=x.device,
                         dtype=torch.float32)
        src = ((y + 0.5) / factor - 0.5).clamp(min=0.0)
        lo = src.floor().long()
        hi = (lo + 1).clamp(max=rows * self.world - 1)
        w_hi = (src - lo).view(1, 1, -1, 1).to(torch.promote_types(x.dtype, torch.float32))
        padded = self.halo(x, 1, 1, mode="edge")            # global row r at r - first + 1
        out = (padded[:, :, lo - first + 1] * (1 - w_hi)
               + padded[:, :, hi - first + 1] * w_hi).to(x.dtype)
        return F.interpolate(out, size=(out_h, out_w), mode="bilinear", align_corners=False)

    def global_mean(self, x) -> torch.Tensor:
        """The [n, c] mean over all rows and columns of the image of the
        sharded map ``x`` [n, c, rows, w], equal on every rank (a
        collective of the group)."""
        return _GlobalMean.apply(x, self)


def _deepest_halo(model) -> tuple[int, int]:
    """(rows, dilation) of the deepest halo that a conv of ``model``'s
    sharded region reads at its deepest stride (``model.spatial_deepest()``;
    a "same" conv's top padding for rows divisible by its stride)."""
    from ..models.layers import Conv2dSame, halo_rows, same_padding
    best = (0, 1)
    for region in model.spatial_deepest():
        for m in region.modules():
            if isinstance(m, nn.Conv2d):
                k, st, d = m.kernel_size[0], m.stride[0], m.dilation[0]
                p = same_padding(k, st, d)[0] if isinstance(m, Conv2dSame) else m.padding[0]
                best = max(best, (max(halo_rows(k, st, d, p)), d))
    return best


def check_spatial(model, spatial: int, crop_h: int):
    """Raise where ``spatial`` ranks cannot split ``model``'s rows at a crop
    of ``crop_h`` rows: a model other than an EMRT with a ResNet, ResNeXt,
    ResNeSt or HRNet backbone (``spatial_stride`` None: the transformer
    backbones' EMRTs and the zoo), rows at the sharded region's deepest
    stride (a ResNet's output stride, 32 for the others) that ``spatial``
    does not divide, or a conv's halo there deeper than a rank's rows (the
    dilation-4 convs of a ResNet at output stride 8 read 4 rows each
    side)."""
    stride = getattr(model, "spatial_stride", None)
    if stride is None:
        if getattr(model, "variant", None) in ("taps", "mit"):
            raise NotImplementedError(
                f"PARALLEL.SPATIAL {spatial}: the EMRT's transformer backbone (CSwin, ViT, "
                f"SegFormer-B4) attends over all tokens, and its spatial sharding is not "
                f"ported (ROADMAP.md queue 1, item 4)")
        raise NotImplementedError(
            f"PARALLEL.SPATIAL {spatial}: spatial sharding is ported for EMRTs with a ResNet, "
            f"ResNeXt, ResNeSt or HRNet backbone; not for {type(model).__name__} (the zoo: "
            f"ROADMAP.md queue 1, item 5)")
    deepest = crop_h // stride
    if crop_h % stride or deepest % spatial:
        raise ValueError(f"PARALLEL.SPATIAL {spatial} does not divide the {crop_h / stride:g} "
                         f"rows of a {crop_h}-row crop at output stride {stride}")
    halo, dilation = _deepest_halo(model)
    if deepest // spatial < halo:
        raise ValueError(f"PARALLEL.SPATIAL {spatial}: the {deepest // spatial} rows a rank "
                         f"holds at output stride {stride} are fewer than the halo of its "
                         f"dilation-{dilation} convs ({halo} rows)")


def shard_model_(model, rank: int, world: int, group):
    """Give the sharded region of ``model`` (an EMRT with a convolutional
    backbone) rank ``rank``'s ``SpatialShard`` of ``world`` in place: its
    convs halo exchange (``layers.HaloConv2d``; a ``Conv2dSame`` by its
    global padding), its pools and resizes too, its dropout keeps the
    rank's rows of the full mask, its BatchNorm over maps takes statistics
    over the gradient group (data x spatial; ``sync_bn``), and the model
    gathers and cuts rows at the region's edges. A BatchNorm over vectors
    (ResNeSt's gate after the global mean) holds the same values on every
    rank of the group and stays on the data group. Parameters, buffers and
    keys stay as they are. Returns ``model``."""
    from ..models.layers import HaloConv2d
    if world == 1:
        return model
    shard = SpatialShard(rank, world, group)
    model.spatial = shard
    for region in model.spatial_region():
        for m in region.modules():
            if type(m) is nn.Conv2d:
                m.__class__ = HaloConv2d
            if hasattr(m, "spatial"):
                m.spatial = shard
            if isinstance(m, nn.BatchNorm2d):
                m.spatial_stats = True
    return model


def shard_for_the_group(model):
    """Shard ``model`` over this rank's spatial group (PARALLEL.SPATIAL
    ranks of ``parallel.mesh.model_parallel``; nothing for 1), as the train
    CLI does; logs the layout. Returns ``model``."""
    from ..utils import logger
    from .mesh import data_world, spatial_group, spatial_rank, spatial_world
    s = spatial_world()
    if s > 1:
        shard_model_(model, spatial_rank(), s, spatial_group())
        logger.info(f"spatial parallelism: spatial axis = {s} (data axis = {data_world()})")
    return model
