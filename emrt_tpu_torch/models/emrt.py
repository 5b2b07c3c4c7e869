"""EMRT: Enhancing Multiscale Representations with Transformer (flagship).

Counterpart of ``emrt_tpu/models/emrt.py`` (reference
src/models/paddle_EMRT.py:13-304) in NCHW: ResNet backbone, CNN spatial
branch, pyramid-pooling tokens driving the deformable-attention
encoder-decoder, enhanced feature pyramid (EFP), PSP-token re-broadcast,
progressive-upsampling head and auxiliary FCN head. Attribute names are the
reference's (``backbone``, ``spatial_branch``, ``psp_module``, ``model``,
``EFP``, ``cls_psp``, ``uphead``, ``auxlayer``), so its state-dict keys
are Paddle's.

forward(images [n, 3, H, W]) -> (main_logits, aux_logits), both float32
[n, num_classes, H, W]. With ``dtype=torch.bfloat16`` the body runs under
``torch.autocast``: convolutions and projections in bf16, norms and the
attention softmax in float32.

Only the ResNet backbones are ported; the other variants wait (ROADMAP.md
queue 1, M10).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pooling import adaptive_avg_pool
from ..ops.resize import resize_bilinear
from .backbones.resnet import _DEPTHS, backbone_channels, resnet
from .decoders.fcn_head import FCNHead
from .deformable_transformer import EncoderDecoder, tokens_to_levels
from .layers import BatchNorm2d, ConvBNReLU, kaiming_normal_


class Conv2dBlock(nn.Module):
    """Two conv3x3-BN-ReLU with residual (reference paddle_EMRT.py:13-29)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = ConvBNReLU(features, features, 3)
        self.conv2 = ConvBNReLU(features, features, 3)

    def forward(self, x):
        return self.conv2(self.conv1(x)) + x


class EFP(nn.Module):
    """Enhanced feature pyramid: top-down residual fusion (reference :31-48)."""

    def __init__(self, features: int = 256):
        super().__init__()
        self.conv0 = Conv2dBlock(features)
        self.conv1 = Conv2dBlock(features)
        self.conv2 = Conv2dBlock(features)

    def forward(self, x0, x1, x2):
        out2 = resize_bilinear(self.conv2(x2), x1.shape[2:], align_corners=True)
        out21 = resize_bilinear(self.conv1(x1) + out2, x0.shape[2:],
                                align_corners=True)
        return self.conv0(x0) + out21


class _AdaptiveAvgPool(nn.Module):
    def __init__(self, output_size: int):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return adaptive_avg_pool(x, self.output_size)


class PyramidPoolingModule(nn.Module):
    """Adaptive-pool pyramid -> 1x1 conv-BN-ReLU -> flattened tokens
    (reference :50-78). Returns [bs, sum(s^2), C] token-major."""

    def __init__(self, pool_scales: Sequence[int] = (1, 3, 6, 8), channels: int = 256):
        super().__init__()
        self.pool_branches = nn.ModuleList(
            nn.Sequential(_AdaptiveAvgPool(s), *ConvBNReLU(channels, channels, 1))
            for s in pool_scales)

    def forward(self, x):
        return torch.cat([branch(x).flatten(2).transpose(1, 2)
                          for branch in self.pool_branches], dim=1)


class _SpatialStage(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.encode = nn.Sequential(*ConvBNReLU(cin, cout, 3),
                                    *ConvBNReLU(cout, cout, 3))

    def forward(self, x):
        return self.encode(F.max_pool2d(x, 3, stride=2, padding=1))


class SpatialBranch(nn.Module):
    """3x (maxpool/2 + 2x conv3x3-BN-ReLU): 3->64->128->256 at 1/8 res
    (reference :80-113)."""

    def __init__(self):
        super().__init__()
        self.Enc0 = _SpatialStage(3, 64)
        self.Enc1 = _SpatialStage(64, 128)
        self.Enc2 = _SpatialStage(128, 256)

    def forward(self, x):
        return self.Enc2(self.Enc1(self.Enc0(x)))


class UpHead(nn.Module):
    """3x conv3x3-BN-ReLU with progressive 2x ups + 1x1 cls + final 2x
    (reference :115-181, num_conv=3 path => 8x upsample total).

    As in the reference, ``conv_0..2`` carry biases (the JAX package folds
    them into the BN means); they start at zero."""

    def __init__(self, num_classes: int = 6):
        super().__init__()
        for i in range(3):
            setattr(self, f"conv_{i}", kaiming_normal_(nn.Conv2d(256, 256, 3, padding=1)))
            setattr(self, f"syncbn_fc_{i}", BatchNorm2d(256, eps=1e-5))
        self.conv_3 = kaiming_normal_(nn.Conv2d(256, num_classes, 1))

    @staticmethod
    def _up(x):
        return resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]), align_corners=False)

    def forward(self, x):
        for i in range(3):
            conv, bn = getattr(self, f"conv_{i}"), getattr(self, f"syncbn_fc_{i}")
            x = F.relu(bn(conv(x)))
            if i < 2:
                x = self._up(x)
        return self._up(self.conv_3(x))


class EMRT(nn.Module):
    """EMRT assembly with a ResNet backbone (reference :183-304)."""

    def __init__(self, num_classes: int = 6, backbone: str = "resnet50",
                 output_stride: int = 32, psp_scales: Sequence[int] = (1, 3, 6, 8),
                 num_encoder_layers: int = 4, num_decoder_layers: int = 2,
                 nhead: int = 8, num_points: int = 6, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        name = backbone.lower()
        depth = int(name[6:]) if name.startswith("resnet") and name[6:].isdigit() else None
        if depth not in _DEPTHS:
            raise NotImplementedError(
                f"backbone {backbone}: the port has the torchvision-style resnet "
                f"depths {sorted(_DEPTHS)} only; the other EMRT backbones are "
                f"ROADMAP.md queue 1, M10 (resnet50c: M3)")
        if output_stride != 32:
            raise NotImplementedError(
                f"output_stride {output_stride}: the dilated ResNet strides are "
                f"ROADMAP.md queue 1, M3")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.dtype = dtype
        self.psp_scales = tuple(psp_scales)
        channels = backbone_channels(depth)
        self.backbone = resnet(depth)
        self.spatial_branch = SpatialBranch()
        self.psp_module = PyramidPoolingModule(self.psp_scales, 256)
        self.model = EncoderDecoder(
            channels[1:], num_queries=sum(s * s for s in self.psp_scales),
            hidden_dim=256, nhead=nhead, num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers, num_encoder_points=num_points,
            num_decoder_points=num_points, dropout=dropout)
        self.EFP = EFP(256)
        # context + one re-broadcast map per PSP scale + the fused pyramid
        self.cls_psp = nn.Sequential(
            *ConvBNReLU(256 * (2 + len(self.psp_scales)), 512, 3),
            *ConvBNReLU(512, 256, 3), nn.Dropout(0.1))
        self.uphead = UpHead(num_classes)
        self.auxlayer = FCNHead(channels[2], max(channels[2] // 4, 16), num_classes)

    def forward(self, images):
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            main, aux = self._forward(images)
        return main.float(), aux.float()

    def _forward(self, x):
        bs = x.shape[0]
        _, c2, c3, c4 = self.backbone(x)
        x_fea = [c2, c3, c4]
        x_context = self.spatial_branch(x)                       # [bs, 256, H/8, W/8]
        x_psp = self.psp_module(x_context)
        x_trans, memory = self.model(x_fea, x_psp)

        # unflatten memory back to the three level maps (reference :265-279)
        spatial_shapes = tuple(tuple(f.shape[2:]) for f in x_fea)
        x_fpn = self.EFP(*tokens_to_levels(memory, spatial_shapes))

        # PSP-token re-broadcast to the context grid (reference :281-291)
        ctx_hw = x_context.shape[2:]
        cat, idx = [x_context], 0
        for s in self.psp_scales:
            pooled = x_trans[:, idx:idx + s * s].transpose(1, 2).reshape(bs, -1, s, s)
            cat.append(resize_bilinear(pooled, ctx_hw, align_corners=True))
            idx += s * s
        cat.append(x_fpn)
        main = self.uphead(self.cls_psp(torch.cat(cat, dim=1)))
        aux = resize_bilinear(self.auxlayer(c3), x.shape[2:], align_corners=True)
        return main, aux


def build_emrt(config, dtype=torch.float32) -> EMRT:
    """Build EMRT from a config node (resnet backbones only)."""
    name = config.MODEL.NAME
    for variant in ("EMRT_CSwin", "EMRT_ViT", "EMRT_HRNet"):
        if variant in name:
            raise NotImplementedError(
                f"model {name}: the {variant} backbone is ROADMAP.md queue 1, M10")
    return EMRT(num_classes=config.DATA.NUM_CLASSES,
                backbone=config.MODEL.ENCODER.TYPE,
                output_stride=config.MODEL.OUTPUT_STRIDE, dtype=dtype)
