"""ViT-MLA backbone: ViT taps + multi-level aggregation (counterpart of
``emrt_tpu/models/backbones/vit_mla.py``; reference
src/models/backbones/vit_mla.py:309-460).

The ViT in its ``drop_prefix_after_pos`` mode (the cls token joins the
position add only), a LayerNorm (eps 1e-6) per tap (``norm_{i}``), then
``ConvMLA``: a 1x1 conv-BN-ReLU per tap, cumulative top-down adds, a 3x3
conv-BN-ReLU on each sum. Parameter names are the reference's
(``vit_mla_backbone_map``): ``transformer.*``, ``norm_{i}``,
``mla.mla_p{2..5}{_1x1,}.{0 conv, 1 bn}``.
"""
from __future__ import annotations

import torch.nn as nn

from ..layers import ConvBNReLU, layer_norm
from .vit import VisionTransformer


class ConvMLA(nn.Module):
    def __init__(self, in_channels: int = 1024, mla_channels: int = 256):
        super().__init__()
        for n in (2, 3, 4, 5):
            setattr(self, f"mla_p{n}_1x1", ConvBNReLU(in_channels, mla_channels, 1))
            setattr(self, f"mla_p{n}", ConvBNReLU(mla_channels, mla_channels, 3))

    def forward(self, res2, res3, res4, res5):
        p5_1x1 = self.mla_p5_1x1(res5)
        p4_plus = p5_1x1 + self.mla_p4_1x1(res4)
        p3_plus = p4_plus + self.mla_p3_1x1(res3)
        p2_plus = p3_plus + self.mla_p2_1x1(res2)
        return (self.mla_p2(p2_plus), self.mla_p3(p3_plus), self.mla_p4(p4_plus),
                self.mla_p5(p5_1x1))


class ViT_MLA(nn.Module):
    """forward(images) -> the four MLA maps [b, mla_channels, H/p, W/p]."""

    def __init__(self, img_size=(512, 512), patch_size: int = 16, hidden_size: int = 1024,
                 num_layers: int = 24, num_heads: int = 16, mlp_ratio: float = 4.0,
                 out_indices=(5, 11, 17, 23), mla_channels: int = 256,
                 dropout: float = 0.0, attn_dropout: float = 0.0):
        super().__init__()
        self.transformer = VisionTransformer(
            img_size, patch_size, hidden_size, num_layers, num_heads, mlp_ratio,
            out_indices, drop_prefix_after_pos=True, dropout=dropout,
            attn_dropout=attn_dropout)
        for i in range(len(out_indices)):
            setattr(self, f"norm_{i}", layer_norm(hidden_size))
        self.mla = ConvMLA(hidden_size, mla_channels)

    def forward(self, x):
        feats = [getattr(self, f"norm_{i}")(f.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                 for i, f in enumerate(self.transformer(x))]
        return self.mla(*feats)
