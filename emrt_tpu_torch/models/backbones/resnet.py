"""torchvision-style ResNet backbone at output stride 32 (counterpart of
``emrt_tpu/models/backbones/resnet.py``; reference
src/models/backbones/paddle_vision_resnet.py).

Returns (c1, c2, c3, c4) at strides 4/8/16/32 in NCHW. Parameter names are
the reference's: ``conv1``, ``bn1``, ``layer{s}.{b}.conv{j}/bn{j}`` and
``downsample.{0,1}`` on the first block of each stage. The deep-stem
``resnet50c`` and the dilated output strides 8/16 wait (ROADMAP.md queue 1,
M3).
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm2d, kaiming_normal_


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return kaiming_normal_(nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                                     bias=False))


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride), _bn(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = _bn(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = _bn(features)
        self.downsample = _downsample(cin, features, stride) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = _bn(features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = _bn(features)
        self.conv3 = _conv(features, features * 4, 1)
        self.bn3 = _bn(features * 4)
        self.downsample = (_downsample(cin, features * 4, stride)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Feature-pyramid ResNet; forward returns (c1, c2, c3, c4)."""

    def __init__(self, layers=(3, 4, 6, 3), block: str = "bottleneck"):
        super().__init__()
        block_cls = Bottleneck if block == "bottleneck" else BasicBlock
        self.conv1 = kaiming_normal_(nn.Conv2d(3, 64, 7, 2, 3, bias=False))
        self.bn1 = _bn(64)
        cin = 64
        for stage, (features, blocks) in enumerate(zip((64, 128, 256, 512), layers),
                                                   start=1):
            stride = 1 if stage == 1 else 2
            # as the JAX package: every stage opens with a projected block
            mods = [block_cls(cin, features, stride, downsample=True)]
            cin = features * block_cls.expansion
            mods += [block_cls(cin, features) for _ in range(1, blocks)]
            setattr(self, f"layer{stage}", nn.Sequential(*mods))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        c1 = self.layer1(x)
        c2 = self.layer2(c1)
        c3 = self.layer3(c2)
        c4 = self.layer4(c3)
        return c1, c2, c3, c4


_DEPTHS = {
    18: ((2, 2, 2, 2), "basic"),
    34: ((3, 4, 6, 3), "basic"),
    50: ((3, 4, 6, 3), "bottleneck"),
    101: ((3, 4, 23, 3), "bottleneck"),
    152: ((3, 8, 36, 3), "bottleneck"),
}


def resnet(depth: int) -> ResNet:
    layers, block = _DEPTHS[depth]
    return ResNet(layers=layers, block=block)


def backbone_channels(depth: int) -> list[int]:
    """(c1..c4) channel counts."""
    if depth in (18, 34):
        return [64, 128, 256, 512]
    return [256, 512, 1024, 2048]
