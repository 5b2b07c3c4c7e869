"""FCN baseline (counterpart of ``emrt_tpu/models/fcn.py``; reference
src/models/fcn.py:22-64): the ResNet (``resnet50c`` and the other depths)
at its output stride, a conv1x1-BN-ReLU to 256 channels, the 1x1
classifier and a resize to the input's size.

Parameter names are the reference's (``fcn_key_map``): ``cnn_encoder.*``,
``head.conv_1.{0 conv, 1 bn}``, ``head.cls``. The reference's head conv has
a bias (the JAX package folds it into the BatchNorm mean); here it is kept,
started at zero.

Under spatial parallelism (``parallel/spatial.py``, ``layers.ShardedWhole``)
the whole model runs on a rank's image rows: the ResNet as in the EMRT (its
convs, dilated ones too, and its max pool through halos), the head on the
rank's rows and its resize through ``layers.upsample``. The deepest halo is
layer4's: a dilation-4 conv reads 4 rows each side at output stride 8.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones.resnet import backbone_channels, resnet
from .layers import BatchNorm2d, ShardedWhole, kaiming_normal_, sharded, upsample


class _Head(nn.Module):
    def __init__(self, cin: int, num_classes: int):
        super().__init__()
        self.conv_1 = nn.Sequential(kaiming_normal_(nn.Conv2d(cin, 256, 1)),
                                    BatchNorm2d(256, eps=1e-5))
        self.cls = kaiming_normal_(nn.Conv2d(256, num_classes, 1))

    def forward(self, x):
        return self.cls(F.relu(self.conv_1(x)))


class FCN(ShardedWhole, nn.Module):
    prefix_tokens = False

    def __init__(self, num_classes: int, backbone: str = "resnet50c", output_stride: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.spatial_stride = output_stride
        depth = int("".join(ch for ch in backbone if ch.isdigit()))
        self.cnn_encoder = resnet(depth, backbone.endswith("c"), output_stride)
        self.head = _Head(backbone_channels(depth)[-1], num_classes)

    def spatial_deepest(self):
        """The ResNet's last stage, at the output stride."""
        return [self.cnn_encoder.layer4]

    def forward(self, images):
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            out = self.head(self.cnn_encoder(images)[-1])
            out = upsample(out, images.shape[2:], sharded(self))
        return [out.float()]
