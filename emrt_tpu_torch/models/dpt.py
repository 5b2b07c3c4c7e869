"""DPT: Dense Prediction Transformer for segmentation (counterpart of
``emrt_tpu/models/dpt.py``; reference src/models/dpt.py:26-41 and
decoders/dpt_head.py:20-265).

The ViT's four taps, each with its cls token: the readout (``ignore``;
``add`` the cls token; ``project``: concatenate it and a Linear + GELU back
to the ViT width), a 1x1 conv to the tap's width, the resample (4x and 2x
``ConvTranspose2d``, identity, a stride-2 3x3 conv), a bias-free 3x3 conv to
``features`` (``layers_rn``), then top-down FeatureFusionBlocks
(pre-activation residual blocks, a 2x resize with align_corners, a 1x1
conv) and the head (conv3x3-BN-ReLU, dropout 0.1, 1x1 classifier, 2x).

Parameter names are the reference's (``dpt_key_map``):
``backbone.transformer.*``, ``head.readout_oper.{i}.proj.0``,
``head.process.{i}.{0,1}``, ``head.layers_rn.{i}``,
``head.refine.{i}.{resblock1,resblock2,out_conv}``, ``head.head.{0,1,4}``.
A Paddle ``Conv2DTranspose`` weight is torch's [in, out, kh, kw] as it is
(the JAX package flips the taps for flax). The reference registers
``head.refine.3.resblock1`` but its forward never runs it (the top fusion
gets no lower map): the port does not build it, and a ``.pdparams`` load
leaves it unread. ``decoder_lr_prefixes``: the Paddle names of the JAX
package's ``head``, ``refine``, ``process`` and ``layers_rn`` parameters
(not the readout's).

Under spatial parallelism (``parallel/spatial.py``, ``layers.ShardedWhole``)
the whole model runs on a rank's image rows: the ViT as SETR's, every rank's
readout with spatial rank 0's cls token of each tap
(``SpatialShard.lead_tokens``: its backward sums the ranks' parts into rank
0's), the ``ConvTranspose2d`` resamples (kernel = stride: local) as they
are, the 3x3 convs, ``process[3]``'s stride-2 one to stride 32 among them,
through halos, the x2 resizes (align_corners True) through
``layers.upsample``, and the head's dropout a ``RowDropout``.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones.vit import ViTEncoder
from .layers import (BatchNorm2d, RowDropout, ShardedWhole, conv2d, kaiming_normal_, sharded,
                     upsample, xavier_uniform_)


class ResidualBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = conv2d(channels, channels, 3)
        self.bn1 = BatchNorm2d(channels, eps=1e-5)
        self.conv2 = conv2d(channels, channels, 3)
        self.bn2 = BatchNorm2d(channels, eps=1e-5)

    def forward(self, x):
        y = self.bn1(self.conv1(F.relu(x)))
        return x + self.bn2(self.conv2(F.relu(y)))


class FeatureFusionBlock(nn.Module):
    spatial = None

    def __init__(self, channels: int, top: bool = False):
        super().__init__()
        self.resblock1 = None if top else ResidualBlock(channels)
        self.resblock2 = ResidualBlock(channels)
        self.out_conv = kaiming_normal_(nn.Conv2d(channels, channels, 1))

    def forward(self, feature, x=None):
        x = feature if x is None else x + self.resblock1(feature)
        x = self.resblock2(x)
        x = upsample(x, (2 * x.shape[2], 2 * x.shape[3]), sharded(self), True)
        return self.out_conv(x)


class _Readout(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Sequential(xavier_uniform_(nn.Linear(2 * dim, dim)),
                                  nn.GELU(approximate="tanh"))


class DPTHead(nn.Module):
    spatial = None

    def __init__(self, hidden_size: int, num_classes: int, readout: str = "project",
                 hidden_features=(256, 512, 1024, 1024), features: int = 256):
        super().__init__()
        if readout not in ("ignore", "add", "project"):
            raise NotImplementedError(f"DPT readout {readout}")
        self.readout = readout
        if readout == "project":
            self.readout_oper = nn.ModuleList(_Readout(hidden_size) for _ in range(4))
        process = []
        for i, hf in enumerate(hidden_features):
            mods = [kaiming_normal_(nn.Conv2d(hidden_size, hf, 1))]
            if i in (0, 1):
                k = 4 if i == 0 else 2
                mods.append(xavier_uniform_(nn.ConvTranspose2d(hf, hf, k, stride=k)))
            elif i == 3:
                mods.append(kaiming_normal_(nn.Conv2d(hf, hf, 3, 2, 1)))
            process.append(nn.Sequential(*mods))
        self.process = nn.ModuleList(process)
        self.layers_rn = nn.ModuleList(conv2d(hf, features, 3) for hf in hidden_features)
        self.refine = nn.ModuleList(FeatureFusionBlock(features, top=i == 3) for i in range(4))
        self.head = nn.Sequential(conv2d(features, features, 3),
                                  BatchNorm2d(features, eps=1e-5), nn.ReLU(),
                                  RowDropout(0.1),
                                  kaiming_normal_(nn.Conv2d(features, num_classes, 1)))

    def forward(self, feats, cls_taps):
        processed = []
        for i, (f, cls) in enumerate(zip(feats, cls_taps)):
            if self.readout == "add":
                f = f + cls[:, :, None, None]
            elif self.readout == "project":
                t = f.permute(0, 2, 3, 1)
                t = torch.cat([t, cls[:, None, None, :].expand_as(t)], -1)
                f = self.readout_oper[i].proj(t).permute(0, 3, 1, 2)
            processed.append(self.layers_rn[i](self.process[i](f)))
        y = None
        for i in range(3, -1, -1):
            y = self.refine[i](processed[i], y)
        y = self.head(y)
        return upsample(y, (2 * y.shape[2], 2 * y.shape[3]), sharded(self), True)


class DPTSeg(ShardedWhole, nn.Module):
    decoder_lr_prefixes = ("head.head", "head.refine", "head.process", "head.layers_rn")
    spatial_stride = 32                      # process[3]'s stride-2 conv

    def __init__(self, num_classes: int, readout: str = "project", img_size=(512, 512),
                 patch_size: int = 16, hidden_size: int = 1024, num_layers: int = 24,
                 num_heads: int = 16, mlp_ratio: float = 4.0, out_indices=(5, 11, 17, 23),
                 hidden_features=(256, 512, 1024, 1024), features: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.pdparams_unused = ("head.refine.3.resblock1.",)
        self.backbone = ViTEncoder(img_size=tuple(img_size), patch_size=patch_size,
                                   hidden_size=hidden_size, num_layers=num_layers,
                                   num_heads=num_heads, mlp_ratio=mlp_ratio,
                                   out_indices=out_indices, return_cls=True)
        self.head = DPTHead(hidden_size, num_classes, readout, hidden_features, features)

    def spatial_deepest(self):
        """The modules that run at stride 32: ``process[3]`` (its stride-2
        conv reads one row below at stride 16), ``layers_rn[3]`` and the top
        fusion block."""
        head = self.head
        return [head.process[3], head.layers_rn[3], head.refine[3]]

    def forward(self, images):
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            out = self.head(*self.backbone(images))
        return [out.float()]


def build_dpt(config, dtype=torch.float32) -> DPTSeg:
    trans = config.MODEL.TRANS
    crop_w, crop_h = (int(v) for v in config.DATA.CROP_SIZE)
    return DPTSeg(
        num_classes=config.DATA.NUM_CLASSES,
        readout=config.MODEL.DPT.READOUT_PROCESS,
        img_size=(crop_h, crop_w),
        patch_size=trans.PATCH_SIZE or 16,
        hidden_size=trans.HIDDEN_SIZE,
        num_layers=trans.NUM_LAYERS or 24,
        num_heads=trans.NUM_HEADS or 16,
        mlp_ratio=trans.MLP_RATIO or 4.0,
        out_indices=tuple(config.MODEL.ENCODER.OUT_INDICES),
        hidden_features=tuple(config.MODEL.DPT.HIDDEN_FEATURES),
        features=config.MODEL.DPT.FEATURES,
        dtype=dtype)
