"""Focal Transformer backbone (counterpart of ``emrt_tpu/models/backbones/focal.py``;
reference src/models/backbones/focal_transformer.py).

Per window of size ws, a query attends to
  * its own ws^2 tokens (Swin's relative-position bias),
  * the ring of tokens the four diagonal rolls by the expand size e bring in
    from outside the window (a learned bias per slot),
  * per coarser level k, the (focal_window + 2^k - 1)^2 tokens of the
    window map pooled by ``pool_layers.{k}`` (a learned [wsg^2 -> 1]
    projection over each window's tokens, started at the mean), unfolded
    around its window (a cross-size relative-position bias, -100 on taps
    outside the pooled map).
As the JAX package and the reference: no shift (segmentation hardcodes it
off), EXPAND_STAGES unread, the window shrinks to the map (and e to 0)
where the map is not larger than it. Every index set, unfold pattern and
border mask is a numpy constant, built once (the port's copy of the JAX
package's tables) and held as a non-persistent buffer; the pooled maps'
masks of another input size are built on the fly. The window (so the bias
tables' shapes) depends on the input size: ``img_size`` fixes it. Stage
outputs are the raw pre-downsample maps (NCHW): the UperNet owns the
per-stage LayerNorms.

Under a spatial shard (``parallel/spatial.py``) a block holds the rank's
image rows: its norms and MLP run on them, and its attention takes the map
that every rank's normed rows make after a gather
(``SpatialShard.gather_rows``), padded after the image's last row as one
process pads it: the rolled rings and the pooled levels come from that
whole map, with the masks and unfold tables of the global sizes, and the
queries are the windows the rank's rows fall in (``swin.window_bands``).
The patch embeds' convs read their halos (``layers.HaloConv2d``; the
``useconv`` stem 7/4/2 and downsample 3/2/1).

Parameter names are the reference's (``focal_backbone_map``):
``patch_embed.{proj,norm}``, ``layers.{s}.blocks.{b}.{norm1, pool_layers.{k},
attn.{qkv, proj, relative_position_bias_table,
relative_position_bias_table_to_neighbors,
relative_position_bias_table_to_windows.{k}}, norm2, mlp.{fc1,fc2}}``,
``layers.{s}.downsample.{proj,norm}``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import DropPath, Mlp, RowDropout, layer_norm, sharded, xavier_uniform_
from .swin import (bands_of, const, relative_position_index, window_bands, window_dropout,
                   window_partition, window_reverse)

_ROLLS = ((-1, -1), (-1, 1), (1, -1), (1, 1))      # tl, tr, bl, br, times e


@functools.lru_cache(maxsize=None)
def valid_ind_rolled(ws: int, e: int) -> np.ndarray:
    """Indices into the concatenated (tl, tr, bl, br) rolled windows that lie
    outside the window itself."""
    masks = []
    for corner in ("tl", "tr", "bl", "br"):
        m = np.ones((ws, ws), np.float32)
        rs = slice(None, -e) if corner[0] == "t" else slice(e, None)
        cs = slice(None, -e) if corner[1] == "l" else slice(e, None)
        m[rs, cs] = 0
        masks.append(m)
    return np.nonzero(np.stack(masks).reshape(-1))[0].astype(np.int64)


@functools.lru_cache(maxsize=None)
def cross_position_index(ws: int, fr: int) -> np.ndarray:
    """Relative position index between a ws x ws query window and an fr x fr
    pooled key region."""
    cq = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    ck = np.stack(np.meshgrid(np.arange(fr), np.arange(fr), indexing="ij")).reshape(2, -1)
    rel = cq[:, :, None] - ck[:, None, :]
    rel = rel.transpose(1, 2, 0) + fr - 1
    return (rel[:, :, 0] * (ws + fr - 1) + rel[:, :, 1]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def valid_ind_unfold(kernel: int, stride: int) -> np.ndarray:
    """For stride > 1 unfolds only the bottom-right (kernel - stride + 1)^2
    taps are kept."""
    m = np.zeros((kernel, kernel), np.float32)
    m[stride - 1:, stride - 1:] = 1
    return np.nonzero(m.reshape(-1))[0].astype(np.int64)


def _np_unfold_ones(nwh: int, nww: int, kernel: int, stride: int) -> np.ndarray:
    """Unfold of an all-ones [nwh, nww] map -> [L, kernel^2] (0 on padding)."""
    pad = kernel // 2
    ones = np.zeros((nwh + 2 * pad, nww + 2 * pad), np.float32)
    ones[pad:pad + nwh, pad:pad + nww] = 1
    oh = (nwh + 2 * pad - kernel) // stride + 1
    ow = (nww + 2 * pad - kernel) // stride + 1
    taps = [ones[ki:ki + oh * stride:stride, kj:kj + ow * stride:stride]
            for ki in range(kernel) for kj in range(kernel)]
    return np.stack(taps, -1).reshape(oh * ow, kernel * kernel)


@functools.lru_cache(maxsize=None)
def pooled_mask(nwh: int, nww: int, kernel: int, stride: int) -> np.ndarray:
    """[L, n_taps] additive mask: 0 inside the pooled map, -100 on padded taps."""
    valid = _np_unfold_ones(nwh, nww, kernel, stride)
    if stride > 1:
        valid = valid[:, valid_ind_unfold(kernel, stride)]
    return np.where(valid > 0, 0.0, -100.0).astype(np.float32)


def unfold(x, kernel: int, stride: int):
    """``paddle.nn.Unfold(kernel, stride, padding=kernel // 2)`` of an NHWC
    map, taps row-major over (ki, kj): [b, h, w, c] -> [b, L, kernel^2, c]."""
    b, h, w, c = x.shape
    pad = kernel // 2
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    oh = (h + 2 * pad - kernel) // stride + 1
    ow = (w + 2 * pad - kernel) // stride + 1
    taps = [xp[:, ki:ki + oh * stride:stride, kj:kj + ow * stride:stride]
            for ki in range(kernel) for kj in range(kernel)]
    return torch.stack(taps, 3).reshape(b, oh * ow, kernel * kernel, c)


def _fit(y, th: int, tw: int):
    """Center-trim or zero-pad a map [b, h, w, c] to (th, tw)."""
    h, w = y.shape[1:3]
    if h > th:
        t = (h - th) // 2
        y = y[:, t:t + th]
    elif h < th:
        t = (th - h) // 2
        y = F.pad(y, (0, 0, 0, 0, t, th - h - t))
    if w > tw:
        t = (w - tw) // 2
        y = y[:, :, t:t + tw]
    elif w < tw:
        t = (tw - w) // 2
        y = F.pad(y, (0, 0, t, tw - w - t))
    return y


def _levels(focal_window: int, focal_level: int, pooled: bool):
    """(kernel, stride, fr) of each coarser level's unfold."""
    if not pooled or focal_level <= 1:
        return []
    return [(2 * (focal_window // 2) + 2 ** k + (2 ** k - 1), 2 ** k,
             focal_window + 2 ** k - 1) for k in range(focal_level - 1)]


class FocalAttention(nn.Module):
    """Window attention with focal expansion. forward(x_all, sel): the padded
    fine map [b, hp, wp, c] and the pooled maps -> the windows of the
    window rows ``sel`` [b * len(sel) * nWw, ws^2, dim]."""

    def __init__(self, dim: int, num_heads: int, window_size: int, expand_size: int,
                 levels, qkv_bias: bool = True, dropout: float = 0.0,
                 attn_dropout: float = 0.0, pooled_hw=()):
        super().__init__()
        ws, e = window_size, expand_size
        self.num_heads, self.ws, self.e, self.levels = num_heads, ws, e, tuple(levels)
        nq = ws * ws
        self.qkv = xavier_uniform_(nn.Linear(dim, 3 * dim, bias=qkv_bias))
        self.proj = xavier_uniform_(nn.Linear(dim, dim))

        def table(*shape):
            return nn.Parameter(nn.init.trunc_normal_(torch.empty(*shape), std=0.02,
                                                      a=-0.04, b=0.04))

        self.relative_position_bias_table = table((2 * ws - 1) ** 2, num_heads)
        self.register_buffer("relative_position_index", const(relative_position_index(ws)),
                             persistent=False)
        self.n_rolled = 0
        if e > 0:
            sel = valid_ind_rolled(ws, e)
            self.n_rolled = len(sel)
            self.relative_position_bias_table_to_neighbors = table(
                1, num_heads, nq, self.n_rolled)
            self.register_buffer("valid_ind_rolled", const(sel), persistent=False)
        self.relative_position_bias_table_to_windows = nn.ParameterList(
            table(num_heads, (ws + fr - 1) ** 2) for _, _, fr in self.levels)
        self.pooled_hw = tuple(pooled_hw)
        for k, ((kernel, stride, fr), hw) in enumerate(zip(self.levels, self.pooled_hw)):
            self.register_buffer(f"window_index{k}", const(cross_position_index(ws, fr)),
                                 persistent=False)
            self.register_buffer(f"unfold_index{k}", const(valid_ind_unfold(kernel, stride)),
                                 persistent=False)
            self.register_buffer(f"pooled_mask{k}", const(pooled_mask(*hw, kernel, stride)),
                                 persistent=False)
        self.attn_drop = nn.Dropout(attn_dropout)
        self.proj_drop = nn.Dropout(dropout)

    def forward(self, x_all, sel):
        ws, e, nh = self.ws, self.e, self.num_heads
        x = x_all[0]
        b, h, w, c = x.shape
        hd = c // nh
        nwh, nww = h // ws, w // ws
        n_win = len(sel) * nww

        def windows(t):
            return window_partition(bands_of(t, sel, ws), ws)         # [b*n_win, ws^2, c]

        q, k, v = self.qkv(x).chunk(3, dim=-1)
        q_win = windows(q)
        k_parts, v_parts = [windows(k)], [windows(v)]
        if self.n_rolled:
            for parts, t in ((k_parts, k), (v_parts, v)):
                rolled = torch.cat([windows(torch.roll(t, (dy * e, dx * e), (1, 2)))
                                    for dy, dx in _ROLLS], 1)
                parts.append(rolled[:, self.valid_ind_rolled])
        masks = []
        for lk, (kernel, stride, fr) in enumerate(self.levels):
            pooled = x_all[lk + 1]
            _, kp, vp = self.qkv(pooled).chunk(3, dim=-1)
            ku, vu = unfold(kp, kernel, stride), unfold(vp, kernel, stride)
            if lk > 0:
                sel_taps = getattr(self, f"unfold_index{lk}")
                ku, vu = ku[:, :, sel_taps], vu[:, :, sel_taps]
            for parts, u in ((k_parts, ku), (v_parts, vu)):
                u = u.reshape(b, nwh, nww, fr * fr, c)[:, sel]
                parts.append(u.reshape(b * n_win, fr * fr, c))
            hw = tuple(pooled.shape[1:3])
            mask = (getattr(self, f"pooled_mask{lk}") if hw == self.pooled_hw[lk]
                    else const(pooled_mask(*hw, kernel, stride), x))
            masks.append(mask.view(nwh, nww, -1)[sel].flatten(0, 1))
        k_all, v_all = torch.cat(k_parts, 1), torch.cat(v_parts, 1)
        bw, nq, _ = q_win.shape
        nk = k_all.shape[1]
        vh = v_all.reshape(bw, nk, nh, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q_win.reshape(bw, nq, nh, hd) * hd ** -0.5,
                            k_all.reshape(bw, nk, nh, hd)).float()

        bias = self.relative_position_bias_table[self.relative_position_index.view(-1)]
        segs = [attn[..., :nq] + bias.view(nq, nq, nh).permute(2, 0, 1)[None].float()]
        off = nq
        if self.n_rolled:
            segs.append(attn[..., off:off + self.n_rolled]
                        + self.relative_position_bias_table_to_neighbors.float())
            off += self.n_rolled
        for lk, (_, _, fr) in enumerate(self.levels):
            idx = getattr(self, f"window_index{lk}")
            wbias = self.relative_position_bias_table_to_windows[lk][:, idx.view(-1)]
            seg = attn[..., off:off + fr * fr] + wbias.view(nh, nq, fr * fr)[None].float()
            seg = (seg.view(b, n_win, nh, nq, fr * fr)
                   + masks[lk][None, :, None, None, :]).view(bw, nh, nq, fr * fr)
            segs.append(seg)
            off += fr * fr
        grid = (b, nwh, sel)
        attn = window_dropout(torch.cat(segs, -1).softmax(-1).to(vh.dtype), self.attn_drop.p,
                              self.training, grid)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(bw, nq, c)
        return window_dropout(self.proj(out), self.proj_drop.p, self.training, grid)


class FocalBlock(nn.Module):
    """FocalTransformerBlock, shift-free, for an (h, w) map (under a spatial
    shard h is the image's, the rank's rows times the group)."""

    spatial = None

    def __init__(self, dim: int, num_heads: int, resolution, window_size: int = 7,
                 expand_size: int = 3, focal_level: int = 2, focal_window: int = 7,
                 pooled: bool = True, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 dropout: float = 0.0, attn_dropout: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.window_size, self.expand_size = window_size, expand_size
        h, w = resolution
        self.ws, e = self._geometry(h, w)
        ws = self.ws
        hp, wp = h + (ws - h % ws) % ws, w + (ws - w % ws) % ws
        levels = _levels(focal_window, focal_level, pooled)
        self.wsg = [ws // 2 ** k for k in range(len(levels))]
        self.pool_layers = nn.ModuleList()
        for g in self.wsg:
            fc = nn.Linear(g * g, 1)
            nn.init.constant_(fc.weight, 1.0 / (g * g))
            nn.init.zeros_(fc.bias)
            self.pool_layers.append(fc)
        pooled_hw = [(hp // ws * 2 ** k, wp // ws * 2 ** k) for k in range(len(levels))]
        self.norm1 = layer_norm(dim)
        self.attn = FocalAttention(dim, num_heads, ws, e, levels, qkv_bias, dropout,
                                   attn_dropout, pooled_hw)
        self.drop_path = DropPath(drop_path)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _geometry(self, h: int, w: int):
        # a window not smaller than the map shrinks to it, without expansion
        if min(h, w) <= self.window_size:
            return min(h, w), 0
        return self.window_size, self.expand_size

    def forward(self, x):
        """x: [b, h, w, c] (a rank's rows under a shard)."""
        b, h, w, c = x.shape
        ws, shard = self.ws, sharded(self)
        y, first, full = self.norm1(x), 0, h
        if shard is not None:
            y, first, full = shard.gather_rows(y, dim=1), shard.rank * h, h * shard.world
        if self._geometry(full, w) != (ws, self.attn.e):
            raise ValueError(f"map {full}x{w}: the block's window {ws} was made for another "
                             f"input size")
        y = F.pad(y, (0, 0, 0, -w % ws, 0, -full % ws))
        hp, wp = y.shape[1:3]
        x_all = [y]
        for k, (g, fc) in enumerate(zip(self.wsg, self.pool_layers)):
            ph, pw = math.ceil(hp / ws) * 2 ** k, math.ceil(wp / ws) * 2 ** k
            win = _fit(y, ph * g, pw * g).reshape(b, ph, g, pw, g, c)
            win = win.permute(0, 1, 3, 5, 2, 4).reshape(b, ph, pw, c, g * g)
            x_all.append(fc(win)[..., 0])
        sel, rows = window_bands(first, h, hp, ws)
        out = window_reverse(self.attn(x_all, sel), ws, len(sel) * ws, wp)[:, rows, :w]
        x = x + self.drop_path(out)
        return x + self.drop_path(self.mlp(self.norm2(x)))


class FocalPatchEmbed(nn.Module):
    """Patchify conv (kernel = stride = patch), or the overlapped conv embed
    (stem 7x7/s4/p2, downsample 3x3/s2/p1), then LayerNorm; NCHW in,
    NHWC out."""

    def __init__(self, cin: int, dim: int, patch_size: int = 4, use_conv_embed: bool = False,
                 is_stem: bool = False):
        super().__init__()
        if use_conv_embed:
            kern, stride, pad = (7, 4, 2) if is_stem else (3, 2, 1)
        else:
            kern, stride, pad = patch_size, patch_size, 0
        self.proj = xavier_uniform_(nn.Conv2d(cin, dim, kern, stride, pad))
        self.norm = layer_norm(dim)

    def out_size(self, n: int) -> int:
        k, s, p = self.proj.kernel_size[0], self.proj.stride[0], self.proj.padding[0]
        return (n + 2 * p - k) // s + 1

    def forward(self, x):
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class _Layer(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class FocalTransformer(nn.Module):
    """Returns the 4 raw pre-downsample stage maps NCHW at strides 4/8/16/32."""

    def __init__(self, img_size=(512, 512), patch_size: int = 4, embed_dim: int = 96,
                 depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window_size: int = 7,
                 expand_sizes=(3, 3, 3, 3), focal_levels=(2, 2, 2, 2),
                 focal_windows=(7, 5, 3, 1), focal_stages=(0, 1, 2, 3),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, use_conv_embed: bool = False,
                 dropout: float = 0.0, attn_dropout: float = 0.0,
                 drop_path_rate: float = 0.2):
        super().__init__()
        self.patch_embed = FocalPatchEmbed(3, embed_dim, patch_size, use_conv_embed, True)
        self.pos_drop = RowDropout(dropout, 1)
        res = tuple(self.patch_embed.out_size(n) for n in img_size)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        layers, dim, blk = [], embed_dim, 0
        for s, depth in enumerate(depths):
            blocks = [FocalBlock(dim, num_heads[s], res, window_size, expand_sizes[s],
                                 focal_levels[s], focal_windows[s], s in tuple(focal_stages),
                                 mlp_ratio, qkv_bias, dropout, attn_dropout, dpr[blk + d])
                      for d in range(depth)]
            down = None
            if s < len(depths) - 1:
                down = FocalPatchEmbed(dim, dim * 2, 2, use_conv_embed)
                res = tuple(down.out_size(n) for n in res)
            layers.append(_Layer(blocks, down))
            dim, blk = dim * 2, blk + depth
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        x = self.pos_drop(self.patch_embed(x))
        feats = []
        for layer in self.layers:
            for block in layer.blocks:
                x = block(x)
            feats.append(x.permute(0, 3, 1, 2))
            if layer.downsample is not None:
                x = layer.downsample(x.permute(0, 3, 1, 2))
        return feats
