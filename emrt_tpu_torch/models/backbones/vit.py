"""Vision Transformer backbone of EMRT-ViT, SETR and DPT (counterpart of
``emrt_tpu/models/backbones/vit.py``; reference src/models/backbones/vit.py).

Conv patch embed (VALID), the cls token, then the learned position table
of 1 + (H/p)(W/p) rows, pre-norm blocks with fused-qkv attention, and the
token maps at ``out_indices`` with the cls token dropped (NCHW). Two modes
of the JAX ViT: ``drop_prefix_after_pos`` (ViT_MLA: the cls token joins
only the position add and is sliced off before the blocks) and
``return_cls`` (DPT's readout: also each tap's cls token). The table is
made for one input size (``img_size``) and the forward refuses another;
a table of another size is re-interpolated on load
(``utils/checkpoint.py::interp_pos_embed``), as the JAX loader does.

Parameter names are the reference's (``vit_backbone_map``): EMRT and SETR
hold ``encoder.transformer``, DPT ``backbone.transformer``, with
``embeddings.{patch_embeddings, position_embeddings, cls_token}`` and
``encoder.layers.{i}.{attn_norm, attn.{qkv,out}, mlp_norm, mlp.{fc1,fc2}}``.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Mlp, layer_norm, split_dropout, xavier_uniform_


class Attention(nn.Module):
    """Multi-head self-attention, fused ``qkv`` (q, k, v column blocks) and
    ``out``; the softmax in float32. Split over a model group
    (``parallel/tensor.py``; the JAX ``ViTBlock``'s ``MultiHeadAttention``
    under ``tp_rule``), a rank holds its heads' rows of each q, k, v block
    of ``qkv`` and the matching input columns of the output projection,
    whose bias is added once after the group's sum; the ``Mlp`` stays
    replicated."""

    TP_SPLITS = {"qkv.weight": (0, 3), "qkv.bias": (0, 3), "out.weight": (1, 1)}
    tp = None

    def __init__(self, dim: int, num_heads: int, attn_dropout: float = 0.0,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = nn.Dropout(attn_dropout)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        for w in self.qkv.weight.data.chunk(3):
            nn.init.xavier_uniform_(w)
        if qkv_bias:
            nn.init.zeros_(self.qkv.bias)
        self.out = xavier_uniform_(nn.Linear(dim, dim))

    def tp_dims(self) -> dict:
        return {"heads": self.num_heads}

    def attend(self, x):
        """The heads' outputs (a split rank's), concatenated, before the
        output projection."""
        b, n, c = x.shape
        hd = c // self.num_heads
        tp = self.tp
        heads = self.num_heads // (tp.world if tp is not None else 1)
        if tp is not None:
            x = tp.copy_in(x)
        q, k, v = self.qkv(x).view(b, n, 3, heads, hd).unbind(2)
        attn = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
        attn = split_dropout(attn.float().softmax(-1).to(v.dtype), self.attn_drop.p,
                             self.training, 1, tp)
        return torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, heads * hd)

    def project(self, out, linear):
        """The output projection ``linear`` of ``attend``'s heads."""
        if self.tp is None:
            return linear(out)
        return self.tp.reduce_out(F.linear(out, linear.weight), linear.bias)

    def forward(self, x):
        return self.project(self.attend(x), self.out)


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, attn_dropout: float = 0.0):
        super().__init__()
        self.attn_norm = layer_norm(dim)
        self.attn = Attention(dim, num_heads, attn_dropout)
        self.dropout = nn.Dropout(dropout)
        self.mlp_norm = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout)

    def forward(self, x):
        x = x + self.dropout(self.attn(self.attn_norm(x)))
        return x + self.mlp(self.mlp_norm(x))


class Embeddings(nn.Module):
    def __init__(self, img_size, patch_size: int, dim: int):
        super().__init__()
        self.grid = (img_size[0] // patch_size, img_size[1] // patch_size)
        self.patch_embeddings = xavier_uniform_(nn.Conv2d(3, dim, patch_size, patch_size))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.position_embeddings = nn.Parameter(
            nn.init.trunc_normal_(torch.empty(1, 1 + self.grid[0] * self.grid[1], dim),
                                  std=0.02, a=-0.04, b=0.04))

    def forward(self, x):
        x = self.patch_embeddings(x)
        if tuple(x.shape[2:]) != self.grid:
            raise ValueError(f"input {tuple(x.shape[2:])} patches, position table for "
                             f"{self.grid}: the ViT takes one input size")
        x = x.flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(x.shape[0], -1, -1).to(x.dtype)
        return torch.cat([cls, x], 1) + self.position_embeddings.to(x.dtype)


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class VisionTransformer(nn.Module):
    """forward(images) -> the token maps [b, D, H/p, W/p] at out_indices, and
    with ``return_cls`` also the taps' cls tokens [b, D]."""

    def __init__(self, img_size=(256, 256), patch_size: int = 16, hidden_size: int = 1024,
                 num_layers: int = 24, num_heads: int = 16, mlp_ratio: float = 4.0,
                 out_indices=(9, 14, 19, 23), drop_prefix_after_pos: bool = False,
                 return_cls: bool = False, dropout: float = 0.0, attn_dropout: float = 0.0):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.drop_prefix_after_pos = drop_prefix_after_pos
        self.return_cls = return_cls
        self.embeddings = Embeddings(img_size, patch_size, hidden_size)
        self.dropout = nn.Dropout(dropout)
        self.encoder = _Layers(EncoderLayer(hidden_size, num_heads, mlp_ratio, dropout,
                                            attn_dropout) for _ in range(num_layers))

    def forward(self, x):
        x = self.embeddings(x)
        if self.drop_prefix_after_pos:
            x = x[:, 1:]
        x = self.dropout(x)
        gh, gw = self.embeddings.grid
        feats, cls_taps = [], []
        for i, layer in enumerate(self.encoder.layers):
            x = layer(x)
            if i in self.out_indices:
                grid = x[:, -gh * gw:]
                feats.append(grid.transpose(1, 2).reshape(x.shape[0], -1, gh, gw))
                cls_taps.append(x[:, 0])
        return (feats, cls_taps) if self.return_cls else feats


class ViTEncoder(nn.Module):
    """The reference's EMRT-ViT ``encoder``: the ViT as ``transformer``."""

    def __init__(self, **kw):
        super().__init__()
        self.transformer = VisionTransformer(**kw)

    def forward(self, x):
        return self.transformer(x)
