"""UperNet decoder head (counterpart of ``emrt_tpu/models/decoders/uper_head.py``;
reference src/models/decoders/uper_head.py:21-122 and psp_head.py:20-63).

Pyramid pooling over the top map (``ops/pooling.py::adaptive_avg_pool``,
the JAX package's bins) into ``bottleneck``, FPN laterals fused top-down,
3x3 ``fpn_convs``, every level resized to the finest and concatenated into
``fpn_bottleneck``, dropout 0.1, the 1x1 ``conv_seg`` classifier, and a 4x
resize. Parameter names are the reference's (``_uper_head_map``):
``psp_modules.pool_branches.{i}.{1 conv, 2 bn}``, ``bottleneck.{0,1}``,
``lateral_convs.{i}.{0,1}``, ``fpn_convs.{i}.{0,1}``,
``fpn_bottleneck.{0,1}``, ``conv_seg``.

Under a spatial shard (``parallel/spatial.py``) the head holds the rank's
rows of every level: the pyramid pooling's bins need the whole top map, so
it is gathered (``SpatialShard.gather_rows``), every rank pools it and
resizes the bins to the whole top map and keeps its rows (``own_rows``);
the bins' conv-BN-ReLUs run on maps every rank holds whole, so their
BatchNorms stay on the data group (``_PSPModules.spatial_replicated``).
The laterals, ``fpn_convs``, ``bottleneck`` and ``fpn_bottleneck`` run
through halos, the resizes (x2 top-down, x2 to x8 to the finest level, the
last x4) through ``layers.upsample`` and the dropout is a ``RowDropout``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ...ops.resize import resize_bilinear
from ..layers import AdaptiveAvgPool, ConvBNReLU, RowDropout, kaiming_normal_, sharded, upsample


class _PSPModules(nn.Module):
    # under a spatial shard its maps are whole on every rank of the group
    # (``parallel/spatial.py::shard_model_`` leaves it as it is)
    spatial_replicated = True

    def __init__(self, pool_scales, cin: int, channels: int):
        super().__init__()
        self.pool_branches = nn.ModuleList(
            nn.Sequential(AdaptiveAvgPool(s), *ConvBNReLU(cin, channels, 1))
            for s in pool_scales)


class UperHead(nn.Module):
    """forward(feats: the four NCHW stage maps) -> logits at 4x the finest."""

    spatial = None

    def __init__(self, in_channels: Sequence[int], pool_scales=(1, 2, 3, 6),
                 channels: int = 512, num_classes: int = 60):
        super().__init__()
        top = in_channels[-1]
        self.psp_modules = _PSPModules(pool_scales, top, channels)
        self.bottleneck = ConvBNReLU(top + len(pool_scales) * channels, channels, 3)
        self.lateral_convs = nn.ModuleList(ConvBNReLU(c, channels, 1)
                                           for c in in_channels[:-1])
        self.fpn_convs = nn.ModuleList(ConvBNReLU(channels, channels, 3)
                                       for _ in in_channels[:-1])
        self.fpn_bottleneck = ConvBNReLU(len(in_channels) * channels, channels, 3)
        self.dropout = RowDropout(0.1)
        self.conv_seg = kaiming_normal_(nn.Conv2d(channels, num_classes, 1))

    def forward(self, inputs):
        top, shard = inputs[-1], sharded(self)
        whole = top if shard is None else shard.gather_rows(top)
        psp = [resize_bilinear(branch(whole), whole.shape[2:])
               for branch in self.psp_modules.pool_branches]
        if shard is not None:
            psp = [shard.own_rows(p) for p in psp]
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        laterals.append(self.bottleneck(torch.cat([top] + psp, 1)))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample(laterals[i], laterals[i - 1].shape[2:],
                                                         shard)
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)] + [laterals[-1]]
        size0 = outs[0].shape[2:]
        outs = [outs[0]] + [upsample(o, size0, shard) for o in outs[1:]]
        out = self.conv_seg(self.dropout(self.fpn_bottleneck(torch.cat(outs, 1))))
        return upsample(out, (4 * size0[0], 4 * size0[1]), shard)
