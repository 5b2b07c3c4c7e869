"""FCN head, the aux segmentation head (counterpart of
``emrt_tpu/models/decoders/fcn_head.py``; reference
src/models/decoders/fcn_head.py:19-81), in the form EMRT and UperNet use
it: one conv-BN-ReLU, dropout, a 1x1 classifier, at the input's resolution
(``up_ratio=1``). Parameter names are the reference's: ``convs.0.{0,1}`` and
``conv_seg``. Its dropout draws the whole map's mask, so that under EMRT's
spatial shard (``parallel/spatial.py``) a rank keeps its rows of it."""
from __future__ import annotations

import torch.nn as nn

from ..layers import ConvBNReLU, RowDropout, kaiming_normal_


class FCNHead(nn.Module):
    def __init__(self, in_channels: int, channels: int, num_classes: int):
        super().__init__()
        self.convs = nn.ModuleList([ConvBNReLU(in_channels, channels, 3)])
        self.dropout = RowDropout(0.1)
        self.conv_seg = kaiming_normal_(nn.Conv2d(channels, num_classes, 1))

    def forward(self, x):
        return self.conv_seg(self.dropout(self.convs[0](x)))
