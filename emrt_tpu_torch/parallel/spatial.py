"""Spatial parallelism over a spatial group (counterpart of
``spatial_batch_sharding``, ``emrt_tpu/parallel/mesh.py:34-44``: the train
batch placed on ``P("data", "spatial")``, image H split over the mesh's
``spatial`` axis, GSPMD inserting the conv halo exchanges and the gathers).

PyTorch has no such pass, so the exchanges are written here by hand. Rank s
of a spatial group of S (``mesh.model_parallel``) holds the rows ``[s * H /
S, (s + 1) * H / S)`` of its data rank's images and labels, and of every
map of the sharded region of an EMRT (``models/emrt.py``, every backbone:
a ResNet, ResNeXt, ResNeSt, HRNet, CSwin, ViT or the SegFormer-B4 MixViT):
the backbone (HRNet's four branches at strides 4 to 32 and its
``input_proj``; CSwin's and ViT's tap norms), the spatial branch, the aux
FCN head, ``cls_psp`` and ``uphead``. Of the zoo, SETR (MLA, PUP, Naive),
the Segmenter (ViT or DeiT; mask transformer or linear decoder), DPT,
SegFormer, UperNet (Swin, CSwin, Focal) and FCN are sharded whole
(``models/layers.ShardedWhole``): their heads' resizes give the rank's rows
(``layers.upsample``), DPT's readout reads spatial rank 0's cls token on
every rank (``lead_tokens``), the mask transformer's class tokens run
replicated on every rank (the attention's ``tail``), Swin's and Focal's
window attentions take the windows of the rank's rows over the gathered
map (``models/backbones/swin.window_bands``) and the UperHead's pyramid
pooling runs over its gathered top map on every rank (its bins' modules are
``spatial_replicated``). Trans2Seg's sharded region is its ResNet and CNN
head; its transformer runs whole on every rank on the gathered c4. What
crosses the region's edges:

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
* ``SpatialShard.upsample_rows``: the rank's rows of a bilinear upsample
  by an integer factor of a sharded map (HRNet's fuse and its stages'
  concat, x2 to x8; the zoo heads' x2 to x16), each output row from the
  source rows ``floor((y + 0.5) / f - 0.5)`` (align_corners False) or
  ``floor(y (in - 1) / (out - 1))`` (True: the MLA head's x4, DPT's x2s)
  and the next of the global frame, clipped at the image's edges: one halo
  row each side;
* ``SpatialShard.lead_tokens``: spatial rank 0's leading tokens on every
  rank (DPT's readout of each tap's cls token); its backward sums the
  ranks' gradients into rank 0's tokens;
* ``SpatialShard.global_mean``: the mean over the whole image of a sharded
  map, replicated on every rank (ResNeSt's split-attention gate): its
  forward all-reduces the ranks' partial sums, its backward the incoming
  gradients (each rank's loss sees only its rows' part of the gate's
  effect) and spreads the sum over the rank's rows;
* ``SpatialShard.gather_rows``: the whole map, every rank's rows in order,
  for the replicated region (the pyramid pooling, the deformable
  encoder-decoder with K1-K3 at the full token count, EFP; the UperHead's
  pyramid pooling; Trans2Seg's transformer), the normed map of a Swin or
  Focal block (its windows, rolled rings and pooled levels), and the keys
  and values of every attention of a transformer backbone, whose queries
  are the rank's own tokens: each rank projects its own rows' keys and
  values and the group gathers them (the Segmenter's class tokens, which
  every rank holds after its patches, are appended from the rank's own copy
  after the gather; CSwin's stripes, with the zero rows
  that pad the map to the stripe size after the image's last row, and
  its LePE conv over the gathered stripes; the MixViT's keys and values
  after the spatial-reduction conv, which sees only the rank's rows; ViT's
  tokens after the cls token, which spatial rank 0 alone holds and which
  leads its block). Its backward sums the gradient over the group and
  keeps the rank's rows: each rank's loss covers only its own rows
  (``losses/cross_entropy.py``), so the replicated region's gradient on a
  rank is its rows' part, and the sum of the parts is the whole;
* ``SpatialShard.own_rows``: a replicated map cut to the rank's rows
  (backward: zeros elsewhere), and ``resize_rows``, an align_corners=True
  bilinear resize of a replicated map that computes only the rank's
  output rows, each from the source row ``y (in - 1) / (out - 1)`` of the
  global frame;
* dropout in the sharded region draws the full-height mask, as one process
  draws it, and keeps the rank's rows (``models/layers.split_dropout``; the
  attention probabilities' mask along the queries); DropPath draws a value
  a sample, alike on every rank.

Every collective runs in float32 at least (exact for the forward's copies). The
modules keep their weights, names and state-dict keys: ``shard_model_``
gives each module of the sharded region the rank's ``SpatialShard``, which
only changes how it runs in training mode; in eval mode the whole model runs
on every rank, as the JAX package evaluates (data-sharded only). Under
tensor parallelism too (PARALLEL.MODEL > 1) each rank of a model group
shards its rows alike: the split transformer runs on the maps its spatial
group gathered, and a head-split ViT attention gathers its heads' keys
and values over its spatial group.
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
    """Every rank's rows in order along ``dim``, after the ``lead`` entries
    that rank 0 alone holds before its rows (ViT's cls token); backward:
    the gradient summed over the group, the rank's entries kept."""

    @staticmethod
    def forward(ctx, x, shard, dim, lead):
        ctx.shard, ctx.dim, ctx.length = shard, dim, x.shape[dim]
        ctx.start = shard.block(x.shape[dim], lead)[0]
        if lead and shard.rank:            # equal sizes for the all-gather
            x = torch.cat([x.new_zeros(*x.shape[:dim], lead, *x.shape[dim + 1:]), x], dim)
        parts = _all_gather(x, shard.group, shard.world)
        parts = parts[:1] + [p.narrow(dim, lead, p.shape[dim] - lead) for p in parts[1:]]
        return torch.cat(parts, dim).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        g = _wide(grad)
        dist.all_reduce(g, group=ctx.shard.group)
        return _GatherRows.own(ctx, g).to(grad.dtype), None, None, None

    @staticmethod
    def own(ctx, g):
        """The rank's entries of ``g``, a gradient of the gathered whole."""
        return g.narrow(ctx.dim, ctx.start, ctx.length)


class _LeadTokens(torch.autograd.Function):
    """Rank 0's first ``lead`` tokens along dim 1, on every rank; backward:
    the gradient summed over the group into rank 0's tokens (each rank's
    loss holds its rows' part), zeros on the other ranks."""

    @staticmethod
    def forward(ctx, x, shard, lead):
        ctx.shard, ctx.shape, ctx.lead = shard, x.shape, lead
        t = (_wide(x[:, :lead]).contiguous() if shard.rank == 0
             else x.new_zeros((x.shape[0], lead, *x.shape[2:]),
                              dtype=torch.promote_types(x.dtype, torch.float32)))
        dist.all_reduce(t, group=shard.group)        # rank 0's tokens, + 0 from the others
        return t.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        g = _wide(grad)
        dist.all_reduce(g, group=ctx.shard.group)
        out = g.new_zeros(ctx.shape)
        if ctx.shard.rank == 0:
            out[:, :ctx.lead] = g
        return out.to(grad.dtype), None, None


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
    rows (``block``: also of tokens, as ``layers.split_dropout`` reads it)."""

    def __init__(self, rank: int, world: int, group):
        self.rank, self.world, self.group = rank, world, group

    def rows(self, n: int) -> slice:
        """This rank's block of a map of ``n`` rows (n divisible by world)."""
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def block(self, n: int, lead: int = 0, tail: int = 0) -> tuple[int, int]:
        """(first, total) of the rank's ``n`` entries along a dim that the
        group splits into equal blocks of rows or tokens, after ``lead``
        entries that rank 0 alone holds (and counts in its ``n``) and before
        ``tail`` entries that every rank holds (and counts; ``total``
        counts them once: the Segmenter's class tokens)."""
        per = n - tail - (lead if self.rank == 0 else 0)
        return ((0 if self.rank == 0 else lead + self.rank * per),
                lead + self.world * per + tail)

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

    def gather_rows(self, x, dim: int = 2, lead: int = 0) -> torch.Tensor:
        """The whole map from every rank's rows along ``dim`` (2 of NCHW, 1
        of NHWC or of tokens [b, n, c]), after the ``lead`` entries that
        rank 0 alone holds (a collective of the group)."""
        return _GatherRows.apply(x, self, dim % x.dim(), lead)

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

    def upsample_rows(self, x, size, align_corners: bool = False) -> torch.Tensor:
        """This rank's rows of ``resize_bilinear(x, size, align_corners)``
        of the sharded map ``x`` upsampled by an integer factor f along H,
        ``size`` the rank's (rows, columns) of the output. Output row y
        (global) interpolates source rows floor(src) and the next, the next
        clipped at the image's last row (torch's and the JAX package's
        rule): src = max((y + 0.5) / f - 0.5, 0) with align_corners False,
        y (in - 1) / (out - 1) of the global frame with True (then the
        first row of rank s reads up to one row of the rank above, less than
        s / S of a row, and its last row at most the first row of the rank
        below: with in = 32 and out = 128 over two ranks, row 63 reads rows
        15 and 16, 0.378 on 16). Either way one row of each neighbour
        (``halo``, the edge row at the image's edges). The columns then go
        through ``F.interpolate`` at the rows' own height (an identity along
        H)."""
        rows, out_h, out_w = x.shape[2], int(size[0]), int(size[1])
        if out_h % rows:
            raise ValueError(f"upsample_rows: {out_h} rows are not an integer factor of {rows}")
        factor = out_h // rows
        first, last = self.rank * rows, rows * self.world - 1
        y = torch.arange(self.rank * out_h, (self.rank + 1) * out_h, device=x.device,
                         dtype=torch.float32)
        if align_corners:
            src = y * (last / (out_h * self.world - 1))
        else:
            src = ((y + 0.5) / factor - 0.5).clamp(min=0.0)
        lo = src.floor().long().clamp(max=last)
        hi = (lo + 1).clamp(max=last)
        w_hi = (src - lo).view(1, 1, -1, 1).to(torch.promote_types(x.dtype, torch.float32))
        padded = self.halo(x, 1, 1, mode="edge")            # global row r at r - first + 1
        out = (padded[:, :, lo - first + 1] * (1 - w_hi)
               + padded[:, :, hi - first + 1] * w_hi).to(x.dtype)
        return F.interpolate(out, size=(out_h, out_w), mode="bilinear",
                             align_corners=align_corners)

    def lead_tokens(self, x, lead: int) -> torch.Tensor:
        """The first ``lead`` tokens [b, lead, c] of rank 0's tokens ``x``
        [b, n, c] on every rank of the group (ViT's cls token, which rank 0
        alone holds, for DPT's readout); backward: the ranks' gradients
        summed into rank 0's tokens, zeros on the others (a collective of
        the group)."""
        return _LeadTokens.apply(x, self, lead)

    def global_mean(self, x) -> torch.Tensor:
        """The [n, c] mean over all rows and columns of the image of the
        sharded map ``x`` [n, c, rows, w], equal on every rank (a
        collective of the group)."""
        return _GlobalMean.apply(x, self)


def _deepest_halo(model) -> tuple[int, int]:
    """(rows, dilation) of the deepest halo that a conv of ``model``'s
    sharded region reads at its deepest stride (``model.spatial_deepest()``;
    a "same" conv's top padding for rows divisible by its stride). A conv
    over a map every rank holds whole (CSwin's LePE over the gathered
    stripes) reads none."""
    from ..models.layers import Conv2dSame, HaloConv2d, halo_rows, same_padding
    best = (0, 1)
    for region in model.spatial_deepest():
        for m in region.modules():
            if type(m) is nn.Conv2d or isinstance(m, (HaloConv2d, Conv2dSame)):
                k, st, d = m.kernel_size[0], m.stride[0], m.dilation[0]
                p = same_padding(k, st, d)[0] if isinstance(m, Conv2dSame) else m.padding[0]
                best = max(best, (max(halo_rows(k, st, d, p)), d))
    return best


def check_spatial(model, spatial: int, crop_h: int):
    """Raise where ``spatial`` ranks cannot split ``model``'s rows at a crop
    of ``crop_h`` rows: rows at the sharded region's deepest stride
    (``model.spatial_stride``: a ResNet's output stride, also FCN's and
    Trans2Seg's; the patch's 16 for an EMRT-ViT, SETR and the Segmenter; 32
    for the other EMRTs, DPT's ``process[3]``, SegFormer and UperNet: then
    also the MixViT's spatial-reduction convs, k = stride = 8, 4, 2 at
    strides 4 to 16, see only the rank's rows, and every rank's row count
    is even for Swin's and Focal's 2x2 merges) that ``spatial`` does not
    divide (DPT's 480^2 yamls: 15 rows at stride 32; UperNet-CSwin's
    224^2: 7), or a conv's halo there deeper than a rank's rows (the
    dilation-4 convs of a ResNet at output stride 8 read 4 rows each side:
    an EMRT's, FCN's or Trans2Seg's)."""
    stride = model.spatial_stride
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
    """Give the sharded region of ``model`` (an EMRT's, Trans2Seg's; the
    whole of a SETR, Segmenter, DPT, SegFormer, UperNet or FCN,
    ``layers.ShardedWhole``) rank ``rank``'s ``SpatialShard`` of ``world``
    in place: its convs halo exchange (``layers.HaloConv2d``; a
    ``Conv2dSame`` by its global padding; not CSwin's LePE conv, which runs
    over gathered stripes; DPT's ``ConvTranspose2d`` resamples, kernel =
    stride, stay local), its pools and resizes too (the zoo heads' through
    ``layers.upsample``), its transformer blocks' attentions take the rank's
    queries over every rank's keys and values (CSwin, ViT, DeiT, the MixViT;
    Swin's and Focal's windows of the rank's rows over the gathered map; the
    mask transformer's class tokens replicated), its dropout keeps the
    rank's rows of the full mask, its BatchNorm over maps takes statistics
    over the gradient group (data x spatial; ``sync_bn``), and an EMRT or
    Trans2Seg gathers and cuts rows at the region's edges. Two kinds of
    module of the region hold the same values on every rank of the group
    and stay on the data group: a BatchNorm over vectors (ResNeSt's gate
    after the global mean), and a module whose ``spatial_replicated`` is
    true, with its children (the UperHead's pyramid-pooling bins, over its
    gathered top map), which is left as it is. Parameters, buffers and keys stay as they are.
    Returns ``model``."""
    from ..models.layers import HaloConv2d
    if world == 1:
        return model
    shard = SpatialShard(rank, world, group)
    model.spatial = shard
    whole = set()
    for region in model.spatial_region():
        for m in region.modules():                  # a module before its children
            if getattr(m, "spatial_replicated", False):
                whole.update(id(sub) for sub in m.modules())
            if id(m) in whole:
                continue
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
