"""SETR PUP / Naive decoder (counterpart of
``emrt_tpu/models/decoders/vit_up_head.py``; reference
src/models/decoders/vit_up_head.py:24-118).

A LayerNorm (eps 1e-6) over the token map's channels, then
* ``num_conv`` 2 (Naive, and every auxiliary head): conv (3x3 or 1x1, 256,
  biased) - BN - ReLU, a 4x resize when ``num_upsample_layer`` is 2, the
  1x1 classifier ``conv_1`` and a resize to 16x the token grid;
* ``num_conv`` 4 (PUP): four conv3x3 (256, biased) - BN - ReLU with a 2x
  resize after the first three, the 1x1 classifier ``conv_4`` and a last 2x.
Parameter names are the reference's: ``norm``, ``conv_{i}``,
``syncbn_fc_{i}``. Under a spatial shard the resizes give the rank's rows
(``layers.upsample``).
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm2d, kaiming_normal_, layer_norm, sharded, upsample


class VisionTransformerUpHead(nn.Module):
    """forward(token map [b, D, h, w]) -> logits."""

    spatial = None

    def __init__(self, in_channels: int, num_classes: int, num_conv: int,
                 num_upsample_layer: int, conv3x3_conv1x1: bool = True,
                 align_corners: bool = False):
        super().__init__()
        if num_conv not in (2, 4):
            raise NotImplementedError(f"num_conv {num_conv}")
        self.num_conv, self.num_upsample_layer = num_conv, num_upsample_layer
        self.align_corners = align_corners
        self.norm = layer_norm(in_channels)
        if num_conv == 2:
            k = 3 if conv3x3_conv1x1 else 1
            self.conv_0 = kaiming_normal_(nn.Conv2d(in_channels, 256, k, padding=k // 2))
            self.syncbn_fc_0 = BatchNorm2d(256, eps=1e-5)
            self.conv_1 = kaiming_normal_(nn.Conv2d(256, num_classes, 1))
        else:
            for i in range(4):
                setattr(self, f"conv_{i}", kaiming_normal_(
                    nn.Conv2d(in_channels if i == 0 else 256, 256, 3, padding=1)))
                setattr(self, f"syncbn_fc_{i}", BatchNorm2d(256, eps=1e-5))
            self.conv_4 = kaiming_normal_(nn.Conv2d(256, num_classes, 1))

    def _up(self, x, size):
        return upsample(x, size, sharded(self), self.align_corners)

    def forward(self, x):
        x = self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        h, w = x.shape[2:]
        if self.num_conv == 2:
            x = F.relu(self.syncbn_fc_0(self.conv_0(x)))
            if self.num_upsample_layer == 2:
                x = self._up(x, (4 * h, 4 * w))
            return self._up(self.conv_1(x), (16 * h, 16 * w))
        for i in range(4):
            x = F.relu(getattr(self, f"syncbn_fc_{i}")(getattr(self, f"conv_{i}")(x)))
            if i < 3:
                x = self._up(x, (2 * x.shape[2], 2 * x.shape[3]))
        x = self.conv_4(x)
        return self._up(x, (2 * x.shape[2], 2 * x.shape[3]))
