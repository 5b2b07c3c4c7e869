"""DeiT, the Segmenter's distilled encoder (counterpart of
``emrt_tpu/models/backbones/vit.py`` with ``num_prefix_tokens=2``; reference
src/models/backbones/deit.py:225-288).

The ViT with two prefix tokens, the class token and the distillation token,
ahead of the patch tokens; the position table has 2 + (H/p)(W/p) rows and is
made for one input size (``img_size``), as the ViT's. forward(images) ->
[the grid tokens of the last layer as a map, b x D x H/p x W/p], with no
final norm (the JAX Segmenter reads the last layer only). A table of
another size is not re-interpolated: the JAX loader treats the first row
alone as the prefix, and so a DeiT table of another size raises in both
packages (ROADMAP.md queue 3, F10). Under a spatial shard
(``parallel/spatial.py``) it runs as the ViT does with two prefix tokens
(``lead`` 2 on its attentions and dropouts): spatial rank 0 alone holds
the class and distillation tokens, each rank its patch rows and their rows
of the position table.

Parameter names are the reference's (``deit_backbone_map``), under the
Segmenter's ``encoder``: ``patch_embed.proj``, ``pos_embed``,
``class_token``, ``distill_token`` and ``layers.{i}.{norm1, attn.{qkv,proj},
norm2, mlp.{fc1,fc2}}``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..layers import Mlp, RowDropout, layer_norm, sharded, xavier_uniform_
from .vit import Attention


class _Attention(Attention):
    """The ViT's attention with its output projection named ``proj``."""

    TP_SPLITS = {"qkv.weight": (0, 3), "qkv.bias": (0, 3), "proj.weight": (1, 1)}

    def __init__(self, dim: int, num_heads: int, attn_dropout: float = 0.0):
        super().__init__(dim, num_heads, attn_dropout)
        self.proj = self.out
        del self.out

    def forward(self, x):
        return self.project(self.attend(x), self.proj)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, attn_dropout: float = 0.0):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = _Attention(dim, num_heads, attn_dropout)
        self.dropout = RowDropout(dropout, 1)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout)

    def forward(self, x):
        x = x + self.dropout(self.attn(self.norm1(x)))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = xavier_uniform_(nn.Conv2d(3, dim, patch_size, patch_size))


class DeiT(nn.Module):
    spatial = None

    def __init__(self, img_size=(512, 512), patch_size: int = 16, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, attn_dropout: float = 0.0):
        super().__init__()
        self.grid = (img_size[0] // patch_size, img_size[1] // patch_size)
        self.patch_embed = _PatchEmbed(patch_size, hidden_size)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        self.distill_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        self.pos_embed = nn.Parameter(
            nn.init.trunc_normal_(torch.empty(1, 2 + self.grid[0] * self.grid[1], hidden_size),
                                  std=0.02, a=-0.04, b=0.04))
        self.dropout = RowDropout(dropout, 1)
        self.layers = nn.ModuleList(Block(hidden_size, num_heads, mlp_ratio, dropout,
                                          attn_dropout) for _ in range(num_layers))
        # under a spatial shard the two prefix tokens lead spatial rank 0's tokens
        for m in self.modules():
            if isinstance(m, (Attention, RowDropout)):
                m.lead = 2

    def forward(self, x):
        x = self.patch_embed.proj(x)
        shard = sharded(self)
        world = 1 if shard is None else shard.world
        b, gh, gw = x.shape[0], x.shape[2], x.shape[3]      # the rank's patch rows
        if (gh * world, gw) != self.grid:
            raise ValueError(f"input {(gh * world, gw)} patches, position table for "
                             f"{self.grid}: DeiT takes one input size")
        x = x.flatten(2).transpose(1, 2)
        pos = self.pos_embed.to(x.dtype)
        first = 0 if shard is None else shard.block(x.shape[1])[0]
        x = x + pos[:, 2 + first:2 + first + x.shape[1]]
        if shard is None or shard.rank == 0:
            prefix = torch.cat([self.class_token, self.distill_token], 1).to(x.dtype)
            x = torch.cat([prefix.expand(b, -1, -1) + pos[:, :2], x], 1)
        x = self.dropout(x)
        for layer in self.layers:
            x = layer(x)
        return [x[:, x.shape[1] - gh * gw:].transpose(1, 2).reshape(b, -1, gh, gw)]
