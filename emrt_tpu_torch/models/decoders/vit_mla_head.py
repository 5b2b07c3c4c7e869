"""SETR-MLA decoder heads (counterpart of
``emrt_tpu/models/decoders/vit_mla_head.py``; reference
src/models/decoders/vit_mla_head.py:20-156 and vit_mla_auxi_head.py:20-62).

``VIT_MLAHead``: per MLA map two conv3x3-BN-ReLU (``head{n}.{0,1,3,4}``),
a 4x resize (align_corners True), the four concatenated into the 3x3
``cls`` conv, then 16x. ``VIT_MLA_AUXIHead``: a bias-free 1x1 classifier
(``aux``; from 1024 channels two, ``aux_0`` and ``aux_1``) and 16x. Under a
spatial shard the resizes give the rank's rows (``layers.upsample``).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..layers import ConvBNReLU, conv2d, kaiming_normal_, sharded, upsample


class VIT_MLAHead(nn.Module):
    spatial = None

    def __init__(self, mla_channels: int = 256, mlahead_channels: int = 128,
                 num_classes: int = 60, align_corners: bool = False):
        super().__init__()
        self.align_corners = align_corners
        for n in (2, 3, 4, 5):
            setattr(self, f"head{n}", nn.Sequential(
                *ConvBNReLU(mla_channels, mlahead_channels, 3),
                *ConvBNReLU(mlahead_channels, mlahead_channels, 3)))
        self.cls = kaiming_normal_(nn.Conv2d(4 * mlahead_channels, num_classes, 3, padding=1))

    def forward(self, mla_p2, mla_p3, mla_p4, mla_p5):
        h, w = mla_p2.shape[2:]
        shard = sharded(self)
        outs = [upsample(getattr(self, f"head{n}")(p), (4 * h, 4 * w), shard, True)
                for n, p in zip((2, 3, 4, 5), (mla_p2, mla_p3, mla_p4, mla_p5))]
        return upsample(self.cls(torch.cat(outs, 1)), (16 * h, 16 * w), shard,
                        self.align_corners)


class VIT_MLA_AUXIHead(nn.Module):
    spatial = None

    def __init__(self, in_channels: int = 256, num_classes: int = 60,
                 align_corners: bool = False):
        super().__init__()
        self.align_corners = align_corners
        if in_channels == 1024:
            self.aux_0 = conv2d(in_channels, 256, 1)
            self.aux_1 = conv2d(256, num_classes, 1)
            self.convs = (self.aux_0, self.aux_1)
        else:
            self.aux = conv2d(in_channels, num_classes, 1)
            self.convs = (self.aux,)

    def forward(self, x):
        h, w = x.shape[2:]
        for conv in self.convs:
            x = conv(x)
        return upsample(x, (16 * h, 16 * w), sharded(self), self.align_corners)
