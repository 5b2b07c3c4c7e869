"""HRNet backbone (counterpart of ``emrt_tpu/models/backbones/hrnet.py``;
reference src/models/backbones/hrnet.py, W18..W64).

Parallel multi-resolution branches with repeated cross-resolution fusion.
forward returns (c1, stage2 maps, stage3 maps, stage4 maps), NCHW.

Parameter names are paddleseg's (the JAX package's ``hrnet_backbone_map``):
every conv-BN pair is ``._conv`` / ``._batch_norm``; ``conv_layer1_{1,2}``
(stem), ``la1.bb_layer2_{i}`` (four bottlenecks, the first with
``conv_down``), ``tr{n}.transition_tr{n}_layer_{i}``, and
``st{n}.stage_st{n}_{m}`` with ``branches_func.bb_st{n}_{m}_branch_layer_{i}_{b}``
and ``fuse_func.residual_st{n}_{m}_layer_{i}_{j}[_{k}]`` (1-based).
The stem, the strided transitions and the fuse-down chains pad TF-style
("same": (0, 1) for a 3x3 stride-2 conv on an even map), as paddleseg does.

Under a spatial shard (``parallel/spatial.py``) every branch runs on the
rank's rows at its own resolution (strides 4 to 32): the convs exchange
halos, the "same" convs by the image's global padding, and the fuse's
upsamples compute the rank's rows (``SpatialShard.upsample_rows``); the
maps a fuse adds cover the same rows. Nothing here pools globally.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm2d, conv2d, sharded, upsample


class ConvBN(nn.Module):
    """paddleseg ``ConvBN`` / ``ConvBNReLU``: ``_conv`` (no bias) and
    ``_batch_norm`` (eps 1e-5), ReLU when ``relu``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding=None, relu: bool = True):
        super().__init__()
        self._conv = conv2d(cin, cout, kernel, stride, padding=padding)
        self._batch_norm = BatchNorm2d(cout, eps=1e-5)
        self.relu = relu

    def forward(self, x):
        x = self._batch_norm(self._conv(x))
        return F.relu(x) if self.relu else x


class BottleneckBlock(nn.Module):
    """``la1``'s bottleneck: 1x1, 3x3, 1x1 (x4), projected shortcut on the first."""

    def __init__(self, cin: int, features: int, downsample: bool):
        super().__init__()
        self.conv1 = ConvBN(cin, features, 1)
        self.conv2 = ConvBN(features, features, 3)
        self.conv3 = ConvBN(features, features * 4, 1, relu=False)
        self.conv_down = ConvBN(cin, features * 4, 1, relu=False) if downsample else None

    def forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(out + (x if self.conv_down is None else self.conv_down(x)))


class BasicBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = ConvBN(channels, channels, 3)
        self.conv2 = ConvBN(channels, channels, 3, relu=False)

    def forward(self, x):
        return F.relu(self.conv2(self.conv1(x)) + x)


class HRModule(nn.Module):
    """``num_blocks`` basic blocks per branch, then the fuse layer: output i
    sums every branch j: j > i through 1x1 conv-BN and a bilinear upsample
    (align_corners False), j < i through a chain of i - j strided 3x3
    conv-BNs (ReLU between them)."""

    spatial = None

    def __init__(self, channels, name: str, num_blocks: int = 4):
        super().__init__()
        n = len(channels)
        self.tag = name
        self.branches_func = nn.ModuleDict({
            f"bb_{name}_branch_layer_{i + 1}_{b + 1}": BasicBlock(c)
            for i, c in enumerate(channels) for b in range(num_blocks)})
        fuse = {}
        for i in range(n):
            for j in range(n):
                if j > i:
                    fuse[f"residual_{name}_layer_{i + 1}_{j + 1}"] = ConvBN(
                        channels[j], channels[i], 1, relu=False)
                for k in range(i - j):
                    last = k == i - j - 1
                    fuse[f"residual_{name}_layer_{i + 1}_{j + 1}_{k + 1}"] = ConvBN(
                        channels[j], channels[i] if last else channels[j], 3, 2,
                        padding="same", relu=not last)
        self.fuse_func = nn.ModuleDict(fuse)
        self.num_blocks = num_blocks

    def forward(self, xs):
        ys = []
        for i, x in enumerate(xs):
            for b in range(self.num_blocks):
                x = self.branches_func[f"bb_{self.tag}_branch_layer_{i + 1}_{b + 1}"](x)
            ys.append(x)
        shard = sharded(self)
        outs = []
        for i in range(len(ys)):
            acc = None
            for j, y in enumerate(ys):
                if j > i:
                    y = self.fuse_func[f"residual_{self.tag}_layer_{i + 1}_{j + 1}"](y)
                    y = upsample(y, ys[i].shape[2:], shard)
                for k in range(i - j):
                    y = self.fuse_func[f"residual_{self.tag}_layer_{i + 1}_{j + 1}_{k + 1}"](y)
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


class HRNet(nn.Module):
    """HRNet-W{width}; forward returns (c1, [s2...], [s3...], [s4...])."""

    def __init__(self, width: int = 48, stage_modules=(1, 4, 3)):
        super().__init__()
        self.width = width
        chs = [width, 2 * width, 4 * width, 8 * width]
        self.conv_layer1_1 = ConvBN(3, 64, 3, 2, padding="same")
        self.conv_layer1_2 = ConvBN(64, 64, 3, 2, padding="same")
        self.la1 = nn.ModuleDict({f"bb_layer2_{b + 1}": BottleneckBlock(
            64 if b == 0 else 256, 64, downsample=b == 0) for b in range(4)})
        self.tr1 = nn.ModuleDict({
            "transition_tr1_layer_1": ConvBN(256, chs[0], 3),
            "transition_tr1_layer_2": ConvBN(256, chs[1], 3, 2, padding="same")})
        self.tr2 = nn.ModuleDict({
            "transition_tr2_layer_3": ConvBN(chs[1], chs[2], 3, 2, padding="same")})
        self.tr3 = nn.ModuleDict({
            "transition_tr3_layer_4": ConvBN(chs[2], chs[3], 3, 2, padding="same")})
        for n, modules in zip((2, 3, 4), stage_modules):
            setattr(self, f"st{n}", nn.ModuleDict({
                f"stage_st{n}_{m + 1}": HRModule(chs[:n], f"st{n}_{m + 1}")
                for m in range(modules)}))

    @staticmethod
    def _stage(stage: nn.ModuleDict, xs):
        for module in stage.values():
            xs = module(xs)
        return xs

    def forward(self, x):
        c1 = self.conv_layer1_2(self.conv_layer1_1(x))
        x = c1
        for block in self.la1.values():
            x = block(x)
        st2 = self._stage(self.st2, [self.tr1["transition_tr1_layer_1"](x),
                                     self.tr1["transition_tr1_layer_2"](x)])
        st3 = self._stage(self.st3, st2 + [self.tr2["transition_tr2_layer_3"](st2[-1])])
        st4 = self._stage(self.st4, st3 + [self.tr3["transition_tr3_layer_4"](st3[-1])])
        return c1, st2, st3, st4
