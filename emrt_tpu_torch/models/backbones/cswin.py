"""CSwin Transformer backbone (counterpart of
``emrt_tpu/models/backbones/cswin.py``; reference
src/models/backbones/cswin_transformer.py).

Cross-shaped-window attention: half the heads attend within vertical
stripes (full height, ``split`` wide; ``attns.0``), half within horizontal
ones (``split`` high, full width; ``attns.1``); the last stage has one
branch over the whole map (``attns.0``). LePE adds a depthwise 3x3 conv of
each stripe's V, zero-padded at the stripe's border. Maps are NHWC inside a
stage; forward takes NCHW images and returns the four stage maps NCHW.

As the JAX package: the map is zero-padded to a multiple of ``split``
after ``norm1`` and before ``qkv``, so padded tokens carry the qkv bias and
take part in the softmax unmasked, and the last stage pads too.

Parameter names are the reference's (``cswin_backbone_map``):
``patch_embedding.{patch_embed,norm}``, ``stages.{s}.blocks.{b}.{norm1,
qkv, attns.{0,1}.get_v, proj, norm2, mlp.{fc1,fc2}}``,
``stages.{s}.merge.{conv,norm}``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import DropPath, Mlp, layer_norm, sharded, xavier_uniform_


def _stripes(x, hs: int, ws: int):
    """[b, h, w, c] -> [b * (h/hs) * (w/ws), hs, ws, c]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // hs, hs, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, hs, ws, c)


def _unstripes(x, hs: int, ws: int, h: int, w: int):
    b = x.shape[0] // ((h // hs) * (w // ws))
    x = x.reshape(b, h // hs, w // ws, hs, ws, x.shape[-1])
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


class _StripeConv(nn.Conv2d):
    """LePE's depthwise conv, over stripes of the whole map: a spatial shard
    (``parallel/spatial.py::shard_model_``) leaves it a plain conv."""


class LePEAttention(nn.Module):
    """Stripe attention with locally-enhanced positional encoding on V.

    ``q`` holds the rows ``[first, first + rows)`` of the map whose keys and
    values ``k``, ``v`` hold every row (one process: all of them; a spatial
    rank: its own rows' queries over the gathered keys and values). The
    queries run over the stripes their rows touch; where they touch more
    than one, the queries are padded with zero rows to those stripes'
    edges, and the padded rows' outputs dropped."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.get_v = xavier_uniform_(_StripeConv(dim, dim, 3, 1, 1, groups=dim))

    def forward(self, q, k, v, hs: int, ws: int, first: int = 0):
        _, rows, w, c = q.shape
        hd = c // self.num_heads
        lo, hi = first // hs * hs, -(-(first + rows) // hs) * hs    # the stripes' rows
        k, v = k[:, lo:hi], v[:, lo:hi]
        top, qh = first - lo, rows
        if hi - lo > hs:
            q = F.pad(q, (0, 0, 0, 0, top, hi - first - rows))
            top, qh = 0, hs
        qs = _stripes(q, qh, ws).reshape(-1, qh * ws, self.num_heads, hd)
        ks = _stripes(k, hs, ws).reshape(-1, hs * ws, self.num_heads, hd)
        v_str = _stripes(v, hs, ws)                                   # [n, hs, ws, c]
        lepe = self.get_v(v_str.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)[:, top:top + qh]
        vs = v_str.reshape(-1, hs * ws, self.num_heads, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", qs * hd ** -0.5, ks)
        attn = attn.float().softmax(-1).to(vs.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vs).reshape(-1, qh, ws, c)
        out = _unstripes(out + lepe, qh, ws, q.shape[1], w)
        return out[:, first - lo:first - lo + rows] if q.shape[1] > rows else out


class CSwinBlock(nn.Module):
    """Under a spatial shard (``parallel/spatial.py``) a rank's block holds
    its rows of the map: the norms, the projections and the MLP run on
    them, each attention's queries are its rows, and the keys and values of
    every rank's rows are gathered (``SpatialShard.gather_rows``), the zero
    rows that pad the map to a multiple of ``split`` (their keys and values
    the qkv bias) after the image's last row."""

    spatial = None

    def __init__(self, dim: int, num_heads: int, split: int, mlp_ratio: float = 4.0,
                 split_heads: bool = True, drop_path: float = 0.0, dropout: float = 0.0):
        super().__init__()
        self.split = split
        self.norm1 = layer_norm(dim)
        self.qkv = xavier_uniform_(nn.Linear(dim, 3 * dim))
        branches = 2 if split_heads else 1
        self.attns = nn.ModuleList(LePEAttention(dim // branches, num_heads // branches)
                                   for _ in range(branches))
        self.proj = xavier_uniform_(nn.Linear(dim, dim))
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        """x: [b, h, w, c]."""
        b, h, w, c = x.shape
        s, shard = self.split, sharded(self)
        y = self.norm1(x)
        if shard is None:
            q, k, v = self.qkv(F.pad(y, (0, 0, 0, -w % s, 0, -h % s))).chunk(3, dim=-1)
            first = 0
        else:
            q, kv = self.qkv(F.pad(y, (0, 0, 0, -w % s))).split((c, 2 * c), -1)
            kv = shard.gather_rows(kv, dim=1)
            pad = self.qkv(y.new_zeros(b, -kv.shape[1] % s, kv.shape[2], c))[..., c:]
            k, v = torch.cat([kv, pad], 1).chunk(2, dim=-1)
            first = shard.rank * h
        hp, wp = k.shape[1:3]
        if len(self.attns) == 2:
            half = c // 2
            attn = torch.cat([
                self.attns[0](q[..., :half], k[..., :half], v[..., :half], hp, s, first),
                self.attns[1](q[..., half:], k[..., half:], v[..., half:], s, wp, first)], -1)
        else:
            attn = self.attns[0](q, k, v, hp, wp, first)
        x = x + self.drop_path(self.proj(attn)[:, :h, :w])
        return x + self.drop_path(self.mlp(self.norm2(x)))


class _PatchEmbedding(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        # padding 2 (not 3): the reference's Conv2D(k=7, s=4, p=2)
        self.patch_embed = xavier_uniform_(nn.Conv2d(3, dim, 7, 4, 2))
        self.norm = layer_norm(dim)

    def forward(self, x):
        return self.norm(self.patch_embed(x).permute(0, 2, 3, 1))


class _Merge(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = xavier_uniform_(nn.Conv2d(dim, 2 * dim, 3, 2, 1))
        self.norm = layer_norm(2 * dim)

    def forward(self, x):
        return self.norm(self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))


class _Stage(nn.Module):
    def __init__(self, blocks, merge):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.merge = merge


class CSwinTransformer(nn.Module):
    """Returns 4 per-stage NCHW maps at strides 4/8/16/32."""

    def __init__(self, embed_dim: int = 64, depths=(1, 2, 21, 1), num_heads=(2, 4, 8, 16),
                 split_sizes=(1, 2, 7, 7), mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.2, dropout: float = 0.0):
        super().__init__()
        self.patch_embedding = _PatchEmbedding(embed_dim)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        stages, dim, blk = [], embed_dim, 0
        for s, depth in enumerate(depths):
            last = s == len(depths) - 1
            blocks = [CSwinBlock(dim, num_heads[s], split_sizes[s], mlp_ratio,
                                 split_heads=not last, drop_path=dpr[blk + d],
                                 dropout=dropout) for d in range(depth)]
            stages.append(_Stage(blocks, None if last else _Merge(dim)))
            dim, blk = dim * 2, blk + depth
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        x = self.patch_embedding(x)
        feats = []
        for stage in self.stages:
            for block in stage.blocks:
                x = block(x)
            feats.append(x.permute(0, 3, 1, 2))
            if stage.merge is not None:
                x = stage.merge(x)
        return feats
