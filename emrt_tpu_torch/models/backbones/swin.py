"""Swin Transformer backbone (counterpart of ``emrt_tpu/models/backbones/swin.py``;
reference src/models/backbones/swin_transformer.py).

Shifted-window attention: each block pads its normed map to a multiple of
the window (zeros, after ``norm1``), rolls it by ``-shift`` on odd blocks,
attends within windows with a relative-position bias (and, when shifted,
the -100 mask of the padded grid's nine regions), rolls back by ``+shift``
and crops. ``PatchMerging`` concatenates each 2x2 patch column-offset
first (x0 = (0, 0), x1 = (1, 0), x2 = (0, 1), x3 = (1, 1) as (row, col)),
as the reference. Maps are NHWC inside; forward takes NCHW images and
returns the four raw stage maps NCHW: the per-stage LayerNorms are the
UperNet's ``layer_norms`` (the JAX package keeps them in its backbone as
``norm{s}``, which its key map sends to the same Paddle keys).

The window shrinks to the map where the map is smaller (and then does not
shift), so the bias tables' shapes depend on the input size: ``img_size``
fixes them, as the JAX package's init shape does. The index table and the
shift mask are numpy constants held as non-persistent buffers; a map of
another padded size builds its mask on the fly.

Under a spatial shard (``parallel/spatial.py``) a block holds the rank's
image rows: the norms, the MLP and ``PatchMerging`` run on them (a rank's
row count is even at every stage: ``spatial_stride`` 32), and the window
attention takes the map that every rank's normed rows make after a gather
(``SpatialShard.gather_rows``), padded and rolled as one process pads and
rolls it (the zero rows after the image's last row, the cyclic wrap of the
first rows of spatial rank 0 into the last window row), then attends within
the windows the rank's rows fall in (``window_bands``) over the global
geometry's tables and mask. Its dropouts draw the mask of every window
(``window_dropout``), so that one process and a shard draw alike.

Parameter names are the reference's (``swin_backbone_map``):
``patch_embedding.{patch_embed,norm}``, ``stages.{s}.blocks.{b}.{norm1,
attn.{qkv,proj,relative_position_bias_table}, norm2, mlp.{fc1,fc2}}``,
``stages.{s}.downsample.{norm,reduction}``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import DropPath, Mlp, RowDropout, layer_norm, sharded, xavier_uniform_


def window_partition(x, ws: int):
    """[b, h, w, c] -> [b * (h/ws) * (w/ws), ws * ws, c]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows, ws: int, h: int, w: int):
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


@functools.lru_cache(maxsize=None)
def relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + ws - 1
    return (rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """[num_windows, ws*ws, ws*ws] additive mask of the shifted windows of an
    (h, w) padded map."""
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mw = img_mask.reshape(1, h // ws, ws, w // ws, ws, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    attn_mask = mw[:, None, :] - mw[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


def const(array: np.ndarray, like=None) -> torch.Tensor:
    """A numpy table as a tensor: on ``like``'s device, or on the default
    device (``torch.device`` contexts included) at build time."""
    return torch.tensor(array, device=None if like is None else like.device)


def _pad_to(n: int, ws: int) -> int:
    return n + (ws - n % ws) % ws


def window_bands(first: int, rows: int, padded: int, ws: int, shift: int = 0):
    """(the window rows, in order, of a map of ``padded`` rows rolled by
    ``-shift`` that the image rows ``[first, first + rows)`` fall in; each of
    those rows' place in the bands of ``ws`` rows of those window rows,
    concatenated). Image row j sits at row (j - shift) mod ``padded`` of the
    rolled map: a shifted map wraps its first rows into the last window
    row."""
    pos = [(j - shift) % padded for j in range(first, first + rows)]
    sel = sorted({p // ws for p in pos})
    where = {r: i for i, r in enumerate(sel)}
    return sel, [where[p // ws] * ws + p % ws for p in pos]


def bands_of(x, sel, ws: int):
    """The bands of window rows ``sel`` of an NHWC map [b, h, w, c],
    concatenated along h."""
    b, h, w, c = x.shape
    return x.reshape(b, h // ws, ws, w, c)[:, sel].reshape(b, len(sel) * ws, w, c)


def window_dropout(t, p: float, training: bool, grid):
    """Dropout of ``t`` [b * len(sel) * nww, ...], the windows of the window
    rows ``sel`` of a map of ``nwh`` window rows (``grid`` = (b, nwh, sel)):
    the keep mask of every window is drawn, as one process draws it, and
    ``sel``'s kept (``layers.split_dropout``'s scaling)."""
    if not training or p == 0.0:
        return t
    b, nwh, sel = grid
    keep = 1.0 - p
    mask = torch.empty((b, nwh, t.shape[0] // (b * len(sel)), *t.shape[1:]), dtype=torch.bool,
                       device=t.device).bernoulli_(keep)[:, sel].reshape(t.shape)
    return torch.ops.aten.native_dropout_backward(t, mask, 1.0 / keep)


class WindowAttention(nn.Module):
    """Multi-head attention within windows, fused ``qkv`` (q, k, v column
    blocks), the relative-position bias and the optional shift mask added
    to the float32 logits; ``grid`` (b, nwh, sel): the windows are those of
    the window rows ``sel`` of ``nwh`` (``window_dropout``)."""

    def __init__(self, dim: int, window_size: int, num_heads: int, attn_dropout: float = 0.0,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = xavier_uniform_(nn.Linear(dim, 3 * dim))
        self.proj = xavier_uniform_(nn.Linear(dim, dim))
        self.relative_position_bias_table = nn.Parameter(nn.init.trunc_normal_(
            torch.empty((2 * window_size - 1) ** 2, num_heads), std=0.02, a=-0.04, b=0.04))
        self.register_buffer("relative_position_index",
                             const(relative_position_index(window_size)), persistent=False)
        self.attn_drop = nn.Dropout(attn_dropout)
        self.proj_drop = nn.Dropout(dropout)

    def forward(self, x, grid, mask=None):
        bw, n, c = x.shape
        hd = c // self.num_heads
        q, k, v = self.qkv(x).view(bw, n, 3, self.num_heads, hd).unbind(2)
        attn = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k).float()
        bias = self.relative_position_bias_table[self.relative_position_index.view(-1)]
        attn = attn + bias.view(n, n, -1).permute(2, 0, 1)[None].float()
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.view(bw // nw, nw, self.num_heads, n, n)
                    + mask[None, :, None]).view(bw, self.num_heads, n, n)
        attn = window_dropout(attn.softmax(-1).to(v.dtype), self.attn_drop.p, self.training,
                              grid)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(bw, n, c)
        return window_dropout(self.proj(out), self.proj_drop.p, self.training, grid)


class SwinBlock(nn.Module):
    """One (shifted-)window block for an (h, w) map: the window is
    min(window_size, h, w), and shifts only when smaller than the map. Under
    a spatial shard h is the image's, the rank's rows times the group."""

    spatial = None

    def __init__(self, dim: int, num_heads: int, resolution, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0, dropout: float = 0.0,
                 attn_dropout: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.ws, self.shift = self._geometry(*resolution)
        self.norm1 = layer_norm(dim)
        self.attn = WindowAttention(dim, self.ws, num_heads, attn_dropout, dropout)
        self.drop_path = DropPath(drop_path)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout)
        h, w = resolution
        self.mask_hw = (_pad_to(h, self.ws), _pad_to(w, self.ws))
        if self.shift:
            self.register_buffer("attn_mask", const(shift_attn_mask(
                *self.mask_hw, self.ws, self.shift)), persistent=False)

    def _geometry(self, h: int, w: int):
        ws = min(self.window_size, h, w)
        return ws, (self.shift_size if ws < min(h, w) else 0)

    def forward(self, x):
        """x: [b, h, w, c] (a rank's rows under a shard)."""
        b, h, w, c = x.shape
        ws, shift, shard = self.ws, self.shift, sharded(self)
        y, first, full = self.norm1(x), 0, h
        if shard is not None:
            y, first, full = shard.gather_rows(y, dim=1), shard.rank * h, h * shard.world
        if self._geometry(full, w) != (ws, shift):
            raise ValueError(f"map {full}x{w}: the block's window {ws} (shift {shift}) was "
                             f"made for another input size")
        y = F.pad(y, (0, 0, 0, -w % ws, 0, -full % ws))
        hp, wp = y.shape[1:3]
        sel, rows = window_bands(first, h, hp, ws, shift)
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), (1, 2))
            mask = (self.attn_mask if (hp, wp) == self.mask_hw
                    else const(shift_attn_mask(hp, wp, ws, shift), x))
            mask = mask.view(hp // ws, wp // ws, ws * ws, ws * ws)[sel].flatten(0, 1)
        y = self.attn(window_partition(bands_of(y, sel, ws), ws), (b, hp // ws, sel), mask)
        y = window_reverse(y, ws, len(sel) * ws, wp)
        if shift:
            y = torch.roll(y, shift, 2)
        x = x + self.drop_path(y[:, rows, :w])
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = layer_norm(4 * dim)
        self.reduction = xavier_uniform_(nn.Linear(4 * dim, 2 * dim, bias=False))

    def forward(self, x):
        b, h, w, c = x.shape
        # [b, h/2, w/2, dx, dy, c]: the reference's x0, x1, x2, x3 order
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
        return self.reduction(self.norm(x.reshape(b, h // 2, w // 2, 4 * c)))


class _PatchEmbedding(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.patch_embed = xavier_uniform_(nn.Conv2d(3, dim, patch_size, patch_size))
        self.norm = layer_norm(dim)

    def forward(self, x):
        return self.norm(self.patch_embed(x).permute(0, 2, 3, 1))


class _Stage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """Returns the 4 raw (pre-merge) stage maps NCHW at strides 4/8/16/32."""

    def __init__(self, img_size=(512, 512), patch_size: int = 4, embed_dim: int = 96,
                 depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, dropout: float = 0.0, attn_dropout: float = 0.0,
                 drop_path_rate: float = 0.2):
        super().__init__()
        self.patch_embedding = _PatchEmbedding(patch_size, embed_dim)
        self.pos_drop = RowDropout(dropout, 1)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        res = (img_size[0] // patch_size, img_size[1] // patch_size)
        stages, dim, blk = [], embed_dim, 0
        for s, depth in enumerate(depths):
            blocks = [SwinBlock(dim, num_heads[s], res, window_size,
                                0 if d % 2 == 0 else window_size // 2, mlp_ratio, dropout,
                                attn_dropout, dpr[blk + d]) for d in range(depth)]
            last = s == len(depths) - 1
            stages.append(_Stage(blocks, None if last else PatchMerging(dim)))
            dim, blk, res = dim * 2, blk + depth, (res[0] // 2, res[1] // 2)
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        x = self.pos_drop(self.patch_embedding(x))
        feats = []
        for stage in self.stages:
            for block in stage.blocks:
                x = block(x)
            feats.append(x.permute(0, 3, 1, 2))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return feats
