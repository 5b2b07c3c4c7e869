"""MixVisionTransformer, the SegFormer encoder (counterpart of
``emrt_tpu/models/backbones/mix_transformer.py``; reference
src/models/backbones/paddleseg_segformer/mix_transformer.py).

Overlapping patch embeds (conv k7 s4, then k3 s2), spatial-reduction
attention, MixFFN with a depthwise 3x3 conv on the 2-D map, a LayerNorm per
stage. Tokens are [b, h*w, c]; forward returns the four stage maps (NCHW)
at strides 4/8/16/32.

Parameter names are paddleseg's (``mixvit_backbone_map``, 1-based stages):
``patch_embed{s}.{proj,norm}``, ``block{s}.{b}.{norm1, attn.{q,kv,proj,sr,
norm}, norm2, mlp.{fc1, dwconv.dwconv, fc2}}``, ``norm{s}``. EMRT holds it
as ``backbone.backbone`` (``SegFormerEncoder``, the reference's SegFormer
wrapper, whose forward returns the encoder's maps; its head is dead weight).

``MixVisionTransformerZoo`` is the same encoder in the layout of the zoo's
SegFormer (reference src/models/backbones/mix_transformer.py:354-463;
``mixvit_zoo_map``): ``layers.{s}.0.{projection,norm}`` (0-based stages),
the blocks ``layers.{s}.1.{b}`` with ``ffn.{fc1, pe_conv, fc2}`` (1x1 convs
around the depthwise one, so the Paddle [out, in, 1, 1] weights load as
they are) and the stage norm ``layers.{s}.2``; the numerics are the JAX
MixViT's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import (Conv2dSame, DropPath, RowDropout, layer_norm, sharded, split_dropout,
                      xavier_uniform_)


class EfficientAttention(nn.Module):
    """Attention whose keys and values come from the map shrunk by ``sr_ratio``
    (a k = stride = sr_ratio conv, flax's default "SAME" padding, which pads
    only a map that is not a multiple of sr_ratio, then a LayerNorm). Under
    a spatial shard (``parallel/spatial.py``) the queries are the rank's
    tokens, ``hw`` its rows of the map: the ``sr`` conv shrinks them alone
    (their count a multiple of sr_ratio), and the reduced keys and values
    of every rank are gathered."""

    spatial = None

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.q = xavier_uniform_(nn.Linear(dim, dim))
        self.kv = xavier_uniform_(nn.Linear(dim, 2 * dim))
        self.proj = xavier_uniform_(nn.Linear(dim, dim))
        self.sr = (xavier_uniform_(Conv2dSame(dim, dim, sr_ratio, sr_ratio))
                   if sr_ratio > 1 else None)
        self.norm = layer_norm(dim) if sr_ratio > 1 else None
        self.dropout = RowDropout(dropout, 1)

    def forward(self, x, hw):
        b, n, c = x.shape
        hd = c // self.num_heads
        shard = sharded(self)
        q = self.q(x).view(b, n, self.num_heads, hd)
        kv_in = x
        if self.sr is not None:
            y = self.sr(x.transpose(1, 2).reshape(b, c, *hw))
            kv_in = self.norm(y.flatten(2).transpose(1, 2))
        kv = self.kv(kv_in).view(b, -1, 2, self.num_heads, hd)
        block = None
        if shard is not None:
            kv, block = shard.gather_rows(kv, dim=1), (2, *shard.block(n), 0)
        k, v = kv.unbind(2)
        attn = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
        attn = split_dropout(attn.float().softmax(-1).to(v.dtype), self.dropout.p,
                             self.training, 2, block=block)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, c)
        return self.dropout(self.proj(out))


class _DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = xavier_uniform_(nn.Conv2d(dim, dim, 3, 1, 1, groups=dim))

    def forward(self, x, hw):
        b, n, c = x.shape
        return self.dwconv(x.transpose(1, 2).reshape(b, c, *hw)).flatten(2).transpose(1, 2)


class MixFFN(nn.Module):
    """fc1 -> depthwise 3x3 on the map -> GELU (tanh) -> fc2."""

    def __init__(self, dim: int, hidden: int, dropout: float = 0.0):
        super().__init__()
        self.fc1 = xavier_uniform_(nn.Linear(dim, hidden))
        self.dwconv = _DWConv(hidden)
        self.fc2 = xavier_uniform_(nn.Linear(hidden, dim))
        self.dropout = RowDropout(dropout, 1)

    def forward(self, x, hw):
        y = F.gelu(self.dwconv(self.fc1(x), hw), approximate="tanh")
        return self.dropout(self.fc2(self.dropout(y)))


class ConvMixFFN(nn.Module):
    """MixFFN with 1x1 convs (the zoo layout): ``fc1`` -> depthwise 3x3
    ``pe_conv`` -> GELU (tanh) -> ``fc2``, on the token map; its dropouts
    on the map (a ``RowDropout`` over rows)."""

    def __init__(self, dim: int, hidden: int, dropout: float = 0.0):
        super().__init__()
        self.fc1 = xavier_uniform_(nn.Conv2d(dim, hidden, 1))
        self.pe_conv = xavier_uniform_(nn.Conv2d(hidden, hidden, 3, 1, 1, groups=hidden))
        self.fc2 = xavier_uniform_(nn.Conv2d(hidden, dim, 1))
        self.dropout = RowDropout(dropout)

    def forward(self, x, hw):
        b, n, c = x.shape
        y = F.gelu(self.pe_conv(self.fc1(x.transpose(1, 2).reshape(b, c, *hw))),
                   approximate="tanh")
        return self.dropout(self.fc2(self.dropout(y))).flatten(2).transpose(1, 2)


class MixBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = EfficientAttention(dim, num_heads, sr_ratio, dropout)
        self.norm2 = layer_norm(dim)
        self.mlp = MixFFN(dim, int(dim * mlp_ratio), dropout)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, hw):
        x = x + self.drop_path(self.attn(self.norm1(x), hw))
        return x + self.drop_path(self.mlp(self.norm2(x), hw))


class _ZooMixBlock(MixBlock):
    """MixBlock in the zoo layout: its FFN is ``ffn``, a ``ConvMixFFN``."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, drop_path: float = 0.0):
        super().__init__(dim, num_heads, sr_ratio, mlp_ratio, dropout, drop_path)
        del self.mlp
        self.ffn = ConvMixFFN(dim, int(dim * mlp_ratio), dropout)

    def forward(self, x, hw):
        x = x + self.drop_path(self.attn(self.norm1(x), hw))
        return x + self.drop_path(self.ffn(self.norm2(x), hw))


class _PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, kernel: int, stride: int):
        super().__init__()
        self.proj = xavier_uniform_(nn.Conv2d(cin, dim, kernel, stride, kernel // 2))
        self.norm = layer_norm(dim)

    def tokens(self, x):
        return self.norm(x.flatten(2).transpose(1, 2)), tuple(x.shape[2:])

    def forward(self, x):
        return self.tokens(self.proj(x))


class _ZooPatchEmbed(_PatchEmbed):
    """_PatchEmbed in the zoo layout: its conv is ``projection``."""

    def __init__(self, cin: int, dim: int, kernel: int, stride: int):
        super().__init__(cin, dim, kernel, stride)
        self.projection = self.proj
        del self.proj

    def forward(self, x):
        return self.tokens(self.projection(x))


_MIT_CONFIGS = {
    # embed_dims, depths
    "b0": ((32, 64, 160, 256), (2, 2, 2, 2)),
    "b1": ((64, 128, 320, 512), (2, 2, 2, 2)),
    "b2": ((64, 128, 320, 512), (3, 4, 6, 3)),
    "b3": ((64, 128, 320, 512), (3, 4, 18, 3)),
    "b4": ((64, 128, 320, 512), (3, 8, 27, 3)),
    "b5": ((64, 128, 320, 512), (3, 6, 40, 3)),
}


class MixVisionTransformer(nn.Module):
    """The MixViT; forward(images) -> the four stage maps (NCHW) at strides
    4/8/16/32, of ``embed_dims`` channels."""

    def __init__(self, embed_dims=(64, 128, 320, 512), depths=(3, 8, 27, 3),
                 num_heads=(1, 2, 5, 8), sr_ratios=(8, 4, 2, 1), mlp_ratio: float = 4.0,
                 dropout: float = 0.0, drop_path_rate: float = 0.1):
        super().__init__()
        self.depths, self.embed_dims = tuple(depths), tuple(embed_dims)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        cin, blk = 3, 0
        for s, (dim, depth) in enumerate(zip(embed_dims, depths), start=1):
            k, stride = (7, 4) if s == 1 else (3, 2)
            setattr(self, f"patch_embed{s}", _PatchEmbed(cin, dim, k, stride))
            setattr(self, f"block{s}", nn.ModuleList(
                MixBlock(dim, num_heads[s - 1], sr_ratios[s - 1], mlp_ratio, dropout,
                         dpr[blk + d]) for d in range(depth)))
            setattr(self, f"norm{s}", layer_norm(dim))
            cin, blk = dim, blk + depth

    def forward(self, x):
        feats = []
        for s in range(1, len(self.depths) + 1):
            tokens, hw = getattr(self, f"patch_embed{s}")(x)
            for block in getattr(self, f"block{s}"):
                tokens = block(tokens, hw)
            tokens = getattr(self, f"norm{s}")(tokens)
            x = tokens.transpose(1, 2).reshape(tokens.shape[0], -1, *hw)
            feats.append(x)
        return feats


class MixVisionTransformerZoo(nn.Module):
    """The MixViT in the zoo SegFormer's layout; forward(images) -> the four
    stage maps (NCHW) at strides 4/8/16/32."""

    def __init__(self, embed_dims=(64, 128, 320, 512), depths=(3, 8, 27, 3),
                 num_heads=(1, 2, 5, 8), sr_ratios=(8, 4, 2, 1), mlp_ratio: float = 4.0,
                 dropout: float = 0.0, drop_path_rate: float = 0.1):
        super().__init__()
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        stages, cin, blk = [], 3, 0
        for s, (dim, depth) in enumerate(zip(embed_dims, depths)):
            k, stride = (7, 4) if s == 0 else (3, 2)
            stages.append(nn.ModuleList([
                _ZooPatchEmbed(cin, dim, k, stride),
                nn.ModuleList(_ZooMixBlock(dim, num_heads[s], sr_ratios[s], mlp_ratio, dropout,
                                           dpr[blk + d]) for d in range(depth)),
                layer_norm(dim)]))
            cin, blk = dim, blk + depth
        self.layers = nn.ModuleList(stages)

    def forward(self, x):
        feats = []
        for embed, blocks, norm in self.layers:
            tokens, hw = embed(x)
            for block in blocks:
                tokens = block(tokens, hw)
            tokens = norm(tokens)
            x = tokens.transpose(1, 2).reshape(tokens.shape[0], -1, *hw)
            feats.append(x)
        return feats


def mit(variant: str, **kw) -> MixVisionTransformer:
    dims, depths = _MIT_CONFIGS[variant]
    return MixVisionTransformer(embed_dims=dims, depths=depths, **kw)


class SegFormerEncoder(nn.Module):
    """The reference SegFormer wrapper as EMRT uses it: ``backbone`` is the
    MixViT, and the forward returns its four maps (segformer_paddleSeg.py:80-84)."""

    def __init__(self, variant: str = "b4"):
        super().__init__()
        self.backbone = mit(variant)

    def forward(self, x):
        return self.backbone(x)
