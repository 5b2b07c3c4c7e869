"""ResNet backbones (counterpart of ``emrt_tpu/models/backbones/resnet.py``).

Two reference variants:
  * torchvision-style ``resnet18/34/50/101/152`` with the 7x7 stem
    (reference src/models/backbones/paddle_vision_resnet.py);
  * ``resnet50c``, the deep stem of three 3x3 convs (reference
    src/models/backbones/resnet.py:107-252).
Both take output stride 32, 16 or 8: the last stages trade their stride for
dilation [1, 1] / [1, 2] / [2, 4].

Returns (c1, c2, c3, c4) in NCHW. Parameter names are the reference's:
``conv1`` (the deep stem's Sequential ``conv1.{0,1,3,4,6}``), ``bn1``,
``layer{s}.{b}.conv{j}/bn{j}`` and ``downsample.{0,1}`` on the first block
of each stage. ``ResNet`` also carries the ResNeXt and ResNeSt blocks
(``resnext.py``).
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm2d, conv2d, max_pool_3x3s2, sharded


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(conv2d(cin, cout, 1, stride), _bn(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv2d(cin, features, 3, stride, dilation)
        self.bn1 = _bn(features)
        self.conv2 = conv2d(features, features, 3, 1, dilation)
        self.bn2 = _bn(features)
        self.downsample = _downsample(cin, features, stride) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv2d(cin, features, 1)
        self.bn1 = _bn(features)
        self.conv2 = conv2d(features, features, 3, stride, dilation)
        self.bn2 = _bn(features)
        self.conv3 = conv2d(features, features * 4, 1)
        self.bn3 = _bn(features * 4)
        self.downsample = (_downsample(cin, features * 4, stride)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


# output stride -> (stride, dilation) of stages 3 and 4
_STRIDES = {32: ((2, 1), (2, 1)), 16: ((2, 1), (1, 2)), 8: ((1, 2), (1, 4))}


class ResNet(nn.Module):
    """Feature-pyramid ResNet; forward returns (c1, c2, c3, c4).

    stem: None for the 7x7 conv, or the widths of a deep stem's three 3x3
    convs (``conv1`` Sequential, its last BatchNorm is ``bn1``). ``spatial``
    is the ``SpatialShard`` of a spatially sharded model (its max pool's
    halo; ``parallel/spatial.py``)."""

    spatial = None

    def __init__(self, layers=(3, 4, 6, 3), block=Bottleneck, stem=None,
                 output_stride: int = 32):
        super().__init__()
        if output_stride not in _STRIDES:
            raise NotImplementedError(f"output_stride {output_stride}: the ResNet "
                                      f"takes {sorted(_STRIDES)}")
        if stem is None:
            self.conv1 = conv2d(3, 64, 7, 2)
            cin = 64
        else:
            a, b, cin = stem
            self.conv1 = nn.Sequential(conv2d(3, a, 3, 2), _bn(a), nn.ReLU(inplace=True),
                                       conv2d(a, b, 3), _bn(b), nn.ReLU(inplace=True),
                                       conv2d(b, cin, 3))
        self.bn1 = _bn(cin)
        stages = ((1, 1), (2, 1), *_STRIDES[output_stride])
        for s, (features, blocks, (stride, dilation)) in enumerate(
                zip((64, 128, 256, 512), layers, stages), start=1):
            # as the JAX package: every stage opens with a projected block,
            # whose dilation is 1 for stage dilation 1 or 2 and 2 for 4
            # (reference _make_layer)
            mods = [block(cin, features, stride, 1 if dilation < 4 else 2, downsample=True)]
            cin = features * block.expansion
            mods += [block(cin, features, 1, dilation) for _ in range(1, blocks)]
            setattr(self, f"layer{s}", nn.Sequential(*mods))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool_3x3s2(x, sharded(self))
        c1 = self.layer1(x)
        c2 = self.layer2(c1)
        c3 = self.layer3(c2)
        c4 = self.layer4(c3)
        return c1, c2, c3, c4


_DEPTHS = {
    18: ((2, 2, 2, 2), BasicBlock),
    34: ((3, 4, 6, 3), BasicBlock),
    50: ((3, 4, 6, 3), Bottleneck),
    101: ((3, 4, 23, 3), Bottleneck),
    152: ((3, 8, 36, 3), Bottleneck),
}


def resnet(depth: int, deep_stem: bool = False, output_stride: int = 32) -> ResNet:
    layers, block = _DEPTHS[depth]
    return ResNet(layers, block, (64, 64, 128) if deep_stem else None, output_stride)


def backbone_channels(depth: int) -> list[int]:
    """(c1..c4) channel counts."""
    if depth in (18, 34):
        return [64, 128, 256, 512]
    return [256, 512, 1024, 2048]
