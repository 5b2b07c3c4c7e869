"""ResNeXt and ResNeSt backbones (counterpart of
``emrt_tpu/models/backbones/resnext.py``; reference
src/models/backbones/resnext.py, resnest.py), returning (c1..c4).

Their blocks plug into ``resnet.ResNet``, so the names follow the port's
ResNet: ``conv1`` / ``bn1`` (ResNeSt's deep stem: ``conv1.{0,1,3,4,6}``),
``layer{s}.{b}.conv{j}/bn{j}``, ``downsample.{0,1}`` and ResNeSt's
``splat.{fc1,bn,fc2}``. The JAX package has no ``.pdparams`` map for these
two, so these names are the port's own (``utils/pdparams_maps.py`` bridges
them from the flax names).

Under a spatial shard (``parallel/spatial.py``) a ResNeSt block's 3x3
average pool reads the row above from the rank above, and its split
attention's pooled sum is the whole image's mean (``global_mean``), equal
on every rank, so the gate after it (its ``BatchNorm1d`` too) runs alike
on every rank of the group. ResNeXt's grouped convs take the halo rules of
any conv.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm1d, avg_pool_3x3, conv2d, kaiming_normal_, sharded
from .resnet import ResNet, _bn, _downsample


class ResNeXtBottleneck(nn.Module):
    """Grouped-conv bottleneck, ``cardinality`` x ``base_width`` (64x4d)."""
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, cardinality: int = 64, base_width: int = 4):
        super().__init__()
        width = int(features * base_width / 64) * cardinality
        self.conv1 = conv2d(cin, width, 1)
        self.bn1 = _bn(width)
        self.conv2 = conv2d(width, width, 3, stride, groups=cardinality)
        self.bn2 = _bn(width)
        self.conv3 = conv2d(width, features * 4, 1)
        self.bn3 = _bn(features * 4)
        self.downsample = (_downsample(cin, features * 4, stride)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class SplitAttention(nn.Module):
    """ResNeSt split attention over ``radix`` groups of ``features`` channels:
    softmax over the groups of a gate computed from their pooled sum."""

    spatial = None

    def __init__(self, features: int, radix: int = 2, reduction: int = 4):
        super().__init__()
        self.radix = radix
        inter = max(features * radix // reduction, 32)
        self.fc1 = kaiming_normal_(nn.Linear(features, inter))
        self.bn = BatchNorm1d(inter, eps=1e-5)
        self.fc2 = kaiming_normal_(nn.Linear(inter, features * radix))

    def forward(self, x):
        b, rc, h, w = x.shape
        splits = x.view(b, self.radix, rc // self.radix, h, w)
        shard = sharded(self)
        total = splits.sum(1)
        gap = total.mean((2, 3)) if shard is None else shard.global_mean(total)   # [b, c]
        att = self.fc2(F.relu(self.bn(self.fc1(gap))))
        att = att.view(b, self.radix, -1).float().softmax(1).to(splits.dtype)
        return torch.einsum("brchw,brc->bchw", splits, att)


class ResNeStBottleneck(nn.Module):
    """Radix-2 split-attention bottleneck; a strided block downsamples with
    3x3 average pooling whose divisor counts the padding (flax's
    ``avg_pool``, torch's ``count_include_pad``), its shortcut with a
    stride x stride average pool before the 1x1 projection."""
    expansion = 4
    spatial = None

    def __init__(self, cin: int, features: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, radix: int = 2):
        super().__init__()
        self.stride = stride
        self.conv1 = conv2d(cin, features, 1)
        self.bn1 = _bn(features)
        self.conv2 = conv2d(features, features * radix, 3, groups=radix)
        self.bn2 = _bn(features * radix)
        self.splat = SplitAttention(features, radix)
        self.conv3 = conv2d(features, features * 4, 1)
        self.bn3 = _bn(features * 4)
        self.downsample = _downsample(cin, features * 4, 1) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.splat(F.relu(self.bn2(self.conv2(out))))
        if self.stride > 1:
            out = avg_pool_3x3(out, self.stride, sharded(self))
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride, self.stride)
            identity = self.downsample(identity)
        return F.relu(out + identity)


def resnext50_64x4d() -> ResNet:
    return ResNet((3, 4, 6, 3), ResNeXtBottleneck)


def resnest50() -> ResNet:
    return ResNet((3, 4, 6, 3), ResNeStBottleneck, stem=(32, 32, 64))
