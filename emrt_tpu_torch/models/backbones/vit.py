"""Vision Transformer backbone of EMRT-ViT, SETR and DPT (counterpart of
``emrt_tpu/models/backbones/vit.py``; reference src/models/backbones/vit.py).

Conv patch embed (VALID), the cls token, then the learned position table
of 1 + (H/p)(W/p) rows, pre-norm blocks with fused-qkv attention, and the
token maps at ``out_indices`` with the cls token dropped (NCHW). Two modes
of the JAX ViT: ``drop_prefix_after_pos`` (ViT_MLA: the cls token joins
only the position add and is sliced off before the blocks) and
``return_cls`` (DPT's readout: also each tap's cls token; under a spatial
shard, where spatial rank 0 alone holds it, every rank gets rank 0's,
``SpatialShard.lead_tokens``). The table is
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

from ..layers import Mlp, RowDropout, layer_norm, sharded, split_dropout, xavier_uniform_


class Attention(nn.Module):
    """Multi-head self-attention, fused ``qkv`` (q, k, v column blocks) and
    ``out``; the softmax in float32. Split over a model group
    (``parallel/tensor.py``; the JAX ``ViTBlock``'s ``MultiHeadAttention``
    under ``tp_rule``), a rank holds its heads' rows of each q, k, v block
    of ``qkv`` and the matching input columns of the output projection,
    whose bias is added once after the group's sum; the ``Mlp`` stays
    replicated. Under a spatial shard (``parallel/spatial.py``) the queries
    are the rank's tokens and the keys and values those of every rank of
    its spatial group (its heads' under tp x sp), gathered after the
    ``lead`` tokens (the cls token; DeiT's class and distillation tokens)
    that spatial rank 0 holds. The last ``tail`` tokens (the Segmenter's
    class tokens in its mask transformer) are replicated: every rank holds
    and runs them, queries among its own, and their keys and values come
    from the rank's own copy after the gathered ones, not gathered (that
    would count them once a rank). Each rank's loss holds its rows' part of
    their gradient; DDP's sum over the gradient group makes the whole, and
    the gather's backward sums over the group the class queries' gradient
    on every rank's keys and values."""

    TP_SPLITS = {"qkv.weight": (0, 3), "qkv.bias": (0, 3), "out.weight": (1, 1)}
    tp = None
    spatial = None
    lead = 0
    tail = 0

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
        tp, shard = self.tp, sharded(self)
        heads = self.num_heads // (tp.world if tp is not None else 1)
        if tp is not None:
            x = tp.copy_in(x)
        qkv = self.qkv(x).view(b, n, 3, heads, hd)
        q, k, v = qkv.unbind(2)
        block = None
        if shard is not None:
            rows = n - self.tail
            kv = shard.gather_rows(qkv[:, :rows, 1:], dim=1, lead=self.lead)
            if self.tail:
                kv = torch.cat([kv, qkv[:, rows:, 1:]], 1)
            k, v = kv.unbind(2)
            block = (2, *shard.block(n, self.lead, self.tail), self.tail)
        attn = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
        attn = split_dropout(attn.float().softmax(-1).to(v.dtype), self.attn_drop.p,
                             self.training, 1, tp, block)
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
        self.dropout = RowDropout(dropout, 1)
        self.mlp_norm = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout)

    def forward(self, x):
        x = x + self.dropout(self.attn(self.attn_norm(x)))
        return x + self.mlp(self.mlp_norm(x))


class Embeddings(nn.Module):
    """The patch embed, the cls token and the position table. Under a
    spatial shard the rank's patch rows take their rows of the table, and
    spatial rank 0 alone holds the cls token (``VisionTransformer``)."""

    spatial = None

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
        shard = sharded(self)
        world = 1 if shard is None else shard.world
        if (x.shape[2] * world, x.shape[3]) != self.grid:
            raise ValueError(f"input {(x.shape[2] * world, x.shape[3])} patches, position "
                             f"table for {self.grid}: the ViT takes one input size")
        x = x.flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(x.shape[0], -1, -1).to(x.dtype)
        pos = self.position_embeddings.to(x.dtype)
        if shard is None:
            return torch.cat([cls, x], 1) + pos
        first, _ = shard.block(x.shape[1])
        x = x + pos[:, 1 + first:1 + first + x.shape[1]]
        return torch.cat([cls + pos[:, :1], x], 1) if shard.rank == 0 else x


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
        self.dropout = RowDropout(dropout, 1)
        self.encoder = _Layers(EncoderLayer(hidden_size, num_heads, mlp_ratio, dropout,
                                            attn_dropout) for _ in range(num_layers))
        if not drop_prefix_after_pos:
            # under a spatial shard the cls token leads spatial rank 0's tokens
            for m in self.modules():
                if isinstance(m, (Attention, RowDropout)):
                    m.lead = 1

    def forward(self, x):
        x = self.embeddings(x)
        shard = sharded(self.embeddings)
        if self.drop_prefix_after_pos and (shard is None or shard.rank == 0):
            x = x[:, 1:]                    # under a shard only rank 0 holds the cls token
        x = self.dropout(x)
        gh, gw = self.embeddings.grid
        gh //= 1 if shard is None else shard.world          # the rank's patch rows
        feats, cls_taps = [], []
        for i, layer in enumerate(self.encoder.layers):
            x = layer(x)
            if i in self.out_indices:
                grid = x[:, -gh * gw:]
                feats.append(grid.transpose(1, 2).reshape(x.shape[0], -1, gh, gw))
                if self.return_cls:         # rank 0's cls token on every rank
                    cls_taps.append(x[:, 0] if shard is None else shard.lead_tokens(x, 1)[:, 0])
        return (feats, cls_taps) if self.return_cls else feats


class ViTEncoder(nn.Module):
    """The reference's EMRT-ViT ``encoder``: the ViT as ``transformer``."""

    def __init__(self, **kw):
        super().__init__()
        self.transformer = VisionTransformer(**kw)

    def forward(self, x):
        return self.transformer(x)
