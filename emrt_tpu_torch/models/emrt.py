"""EMRT: Enhancing Multiscale Representations with Transformer (flagship).

Counterpart of ``emrt_tpu/models/emrt.py`` (reference
src/models/paddle_EMRT.py:13-304) in NCHW: a backbone, CNN spatial branch,
pyramid-pooling tokens driving the deformable-attention encoder-decoder,
enhanced feature pyramid (EFP), PSP-token re-broadcast,
progressive-upsampling head and auxiliary FCN head. Attribute names are the
reference's (``backbone``, ``spatial_branch``, ``psp_module``, ``model``,
``EFP``, ``cls_psp``, ``uphead``, ``auxlayer``), so its state-dict keys
are Paddle's.

Every backbone of the JAX package's EMRT dispatch: the ResNets (resnet18
to resnet152, the deep-stem ``resnet50c``, output stride 32, 16 or 8),
ResNeXt50 (64x4d), ResNeSt50, CSwin and ViT (``encoder``, with a LayerNorm
per tap, ``layer_norms.{i}``), HRNet-W48 (its stages fused by upsample and
concat, then ``input_proj.{i}``, stride-2 conv-BN-ReLUs to 256 channels)
and the SegFormer-B4 MixViT (``backbone.backbone``).

forward(images [n, 3, H, W]) -> (main_logits, aux_logits), both float32
[n, num_classes, H, W]. With ``dtype=torch.bfloat16`` the body runs under
``torch.autocast``: convolutions and projections in bf16, norms and the
attention softmax in float32.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from .backbones.cswin import CSwinTransformer
from .backbones.hrnet import HRNet
from .backbones.mix_transformer import SegFormerEncoder
from .backbones.resnet import _DEPTHS, backbone_channels, resnet
from .backbones.resnext import resnest50, resnext50_64x4d
from .backbones.vit import ViTEncoder
from .decoders.fcn_head import FCNHead
from .deformable_transformer import EncoderDecoder, tokens_to_levels
from .layers import (AdaptiveAvgPool, BatchNorm2d, ConvBNReLU, RowDropout, halo_rows,
                     kaiming_normal_, layer_norm, max_pool_3x3s2, sharded, upsample)


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


class PyramidPoolingModule(nn.Module):
    """Adaptive-pool pyramid -> 1x1 conv-BN-ReLU -> flattened tokens
    (reference :50-78). Returns [bs, sum(s^2), C] token-major."""

    def __init__(self, pool_scales: Sequence[int] = (1, 3, 6, 8), channels: int = 256):
        super().__init__()
        self.pool_branches = nn.ModuleList(
            nn.Sequential(AdaptiveAvgPool(s), *ConvBNReLU(channels, channels, 1))
            for s in pool_scales)

    def forward(self, x):
        return torch.cat([branch(x).flatten(2).transpose(1, 2)
                          for branch in self.pool_branches], dim=1)


class _SpatialStage(nn.Module):
    spatial = None

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.encode = nn.Sequential(*ConvBNReLU(cin, cout, 3),
                                    *ConvBNReLU(cout, cout, 3))

    def forward(self, x):
        return self.encode(max_pool_3x3s2(x, sharded(self)))


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
    them into the BN means); they start at zero. Under a spatial shard
    (``parallel/spatial.py``) each 2x resize reads one row of each
    neighbour (the edge row at the image's top and bottom) and keeps the
    rank's output rows."""

    spatial = None

    def __init__(self, num_classes: int = 6):
        super().__init__()
        for i in range(3):
            setattr(self, f"conv_{i}", kaiming_normal_(nn.Conv2d(256, 256, 3, padding=1)))
            setattr(self, f"syncbn_fc_{i}", BatchNorm2d(256, eps=1e-5))
        self.conv_3 = kaiming_normal_(nn.Conv2d(256, num_classes, 1))

    @staticmethod
    def _up(x, shard=None):
        if shard is None:
            return resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]), align_corners=False)
        # row z of the padded block's 2x resize is the image's row 2k - 2 + z
        # (k the block's first row), from the same source rows and weights
        rows = x.shape[2]
        x = shard.halo(x, *halo_rows(3, 1, 1, 1), mode="edge")
        return resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]),
                               align_corners=False)[:, :, 2:2 + 2 * rows]

    def forward(self, x):
        shard = sharded(self)
        for i in range(3):
            conv, bn = getattr(self, f"conv_{i}"), getattr(self, f"syncbn_fc_{i}")
            x = F.relu(bn(conv(x)))
            if i < 2:
                x = self._up(x, shard)
        return self._up(self.conv_3(x), shard)


class EMRT(nn.Module):
    """EMRT assembly (reference :183-304). The ``trans_*`` knobs shape CSwin,
    the ``vit_*`` knobs and ``img_size`` (h, w) ViT, ``output_stride`` the
    ResNets; the other backbones have fixed widths (HRNet-W48).

    With a ResNet, ResNeXt, ResNeSt or HRNet backbone the model can be
    sharded over image rows (``parallel/spatial.py``; ``spatial_stride`` is
    the deepest stride of its sharded region, None for the transformer
    backbones). In training mode under a ``SpatialShard`` (``spatial``) the
    backbone (with HRNet's ``input_proj``), the spatial branch, the aux
    head, ``cls_psp`` and ``uphead`` run on the rank's rows with halo
    exchanges; their maps are gathered whole for the pyramid pooling, the
    encoder-decoder and EFP, which every rank of the group runs alike; and
    the PSP re-broadcast, the fused pyramid and the aux logits come back to
    the rank's rows. Both outputs are then the rank's rows."""

    spatial = None

    def __init__(self, num_classes: int = 6, backbone: str = "resnet50",
                 output_stride: int = 32, psp_scales: Sequence[int] = (1, 3, 6, 8),
                 num_encoder_layers: int = 4, num_decoder_layers: int = 2,
                 nhead: int = 8, num_points: int = 6, dropout: float = 0.1,
                 trans_embed_dim: int = 64, trans_depths: Sequence[int] = (1, 2, 21, 1),
                 trans_heads: Sequence[int] = (2, 4, 8, 16),
                 trans_splits: Sequence[int] = (1, 2, 7, 7), vit_hidden: int = 1024,
                 vit_layers: int = 24, vit_heads: int = 16,
                 vit_out_indices: Sequence[int] = (9, 14, 19, 23),
                 img_size: Sequence[int] = (256, 256), dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.dtype = dtype
        self.psp_scales = tuple(psp_scales)
        self.spatial_stride = None
        # reference keys the forward never reads: Paddle registers tgt_embed
        # (transformer_encoder_decoder.py:367-369, 469-471); the SegFormer
        # wrapper's head is dead weight (segformer_paddleSeg.py:80-84)
        self.pdparams_unused = ("model.tgt_embed.weight",)
        name = backbone.lower()
        if name.startswith("resnet") and name[6:].rstrip("c").isdigit():
            depth = int(name[6:].rstrip("c"))
            if depth not in _DEPTHS:
                raise NotImplementedError(f"backbone {backbone}: no resnet depth {depth} "
                                          f"(available: {sorted(_DEPTHS)})")
            self.variant = "cnn"
            self.backbone = resnet(depth, name.endswith("c"), output_stride)
            channels = backbone_channels(depth)[1:]
            self.spatial_stride = output_stride
        elif name in ("resnext50", "resnest50"):
            self.variant = "cnn"
            self.backbone = resnext50_64x4d() if name == "resnext50" else resnest50()
            channels = [512, 1024, 2048]
            self.spatial_stride = 32                 # ResNet(...)'s output stride
        elif name == "cswintransformer":
            self.variant = "taps"
            self.encoder = CSwinTransformer(trans_embed_dim, trans_depths, trans_heads,
                                            trans_splits)
            taps = [trans_embed_dim * 2 ** i for i in range(len(trans_depths))]
            self.layer_norms = nn.ModuleList(layer_norm(c) for c in taps)
            channels = taps[1:]
        elif name == "vit":
            self.variant = "taps"
            self.encoder = ViTEncoder(img_size=tuple(img_size), hidden_size=vit_hidden,
                                      num_layers=vit_layers, num_heads=vit_heads,
                                      out_indices=vit_out_indices)
            n_taps = sum(0 <= i < vit_layers for i in vit_out_indices)
            self.layer_norms = nn.ModuleList(layer_norm(vit_hidden) for _ in range(n_taps))
            channels = [vit_hidden] * (n_taps - 1)
        elif name == "hrnet":
            self.variant = "hrnet"
            self.backbone = HRNet()
            w = self.backbone.width
            # each stage's maps concatenated: w(1 + 2 + ...) channels
            self.input_proj = nn.ModuleList(ConvBNReLU(c, 256, 3, stride=2)
                                            for c in (3 * w, 7 * w, 15 * w))
            channels, aux_channels = [256] * 3, 7 * w
            self.spatial_stride = 32                 # the fourth branch
        elif name == "segformer_b4":
            self.variant = "mit"
            self.backbone = SegFormerEncoder("b4")
            self.pdparams_unused += ("backbone.linear_",)
            channels = [128, 320, 512]
        else:
            raise NotImplementedError(f"backbone {backbone}")
        if self.variant != "hrnet":
            aux_channels = channels[1]
        # the first tap's LayerNorm feeds no path (its map is not an encoder
        # level): DistributedDataParallel must look for unused parameters
        self.ddp_find_unused_parameters = self.variant == "taps"
        self.spatial_branch = SpatialBranch()
        self.psp_module = PyramidPoolingModule(self.psp_scales, 256)
        self.model = EncoderDecoder(
            channels, num_queries=sum(s * s for s in self.psp_scales),
            hidden_dim=256, nhead=nhead, num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers, num_encoder_points=num_points,
            num_decoder_points=num_points, dropout=dropout)
        self.EFP = EFP(256)
        # context + one re-broadcast map per PSP scale + the fused pyramid
        self.cls_psp = nn.Sequential(
            *ConvBNReLU(256 * (2 + len(self.psp_scales)), 512, 3),
            *ConvBNReLU(512, 256, 3), RowDropout(0.1))
        self.uphead = UpHead(num_classes)
        self.auxlayer = FCNHead(aux_channels, max(aux_channels // 4, 16), num_classes)

    def spatial_region(self):
        """The modules that run on a rank's rows under a spatial shard."""
        region = (self.backbone, self.spatial_branch, self.auxlayer, self.cls_psp, self.uphead)
        return region + ((self.input_proj,) if self.variant == "hrnet" else ())

    def spatial_deepest(self):
        """The modules of the sharded region that run at its deepest stride
        (``spatial_stride``): a ResNet's last stage, HRNet's fourth branch."""
        if self.variant == "hrnet":
            return [block for module in self.backbone.st4.values()
                    for key, block in module.branches_func.items() if "_branch_layer_4_" in key]
        return [self.backbone.layer4]

    def forward(self, images):
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            main, aux = self._forward(images)
        return main.float(), aux.float()

    def _backbone_features(self, x):
        """(three level maps for the encoder-decoder, the aux head's input)."""
        if self.variant == "cnn":
            _, c2, c3, c4 = self.backbone(x)
            return [c2, c3, c4], c3
        if self.variant == "taps":
            # tap 0's norm exists, as in the reference, but feeds nothing
            feats = [self.layer_norms[i](f.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                     for i, f in enumerate(self.encoder(x)) if i > 0]
            return feats, feats[1]
        if self.variant == "hrnet":
            _, *stages = self.backbone(x)
            shard = sharded(self)
            fused = [torch.cat([s[0]] + [upsample(t, s[0].shape[2:], shard) for t in s[1:]],
                               dim=1) for s in stages]
            return [proj(f) for proj, f in zip(self.input_proj, fused)], fused[1]
        feats = self.backbone(x)
        return feats[1:], feats[2]

    def _forward(self, x):
        bs = x.shape[0]
        shard = sharded(self)
        x_fea, aux_feat = self._backbone_features(x)
        x_context = self.spatial_branch(x)                       # [bs, 256, H/8, W/8]
        ctx_full = x_context
        if shard is not None:      # the rows of every rank, for the replicated region
            x_fea = [shard.gather_rows(f) for f in x_fea]
            ctx_full = shard.gather_rows(x_context)
        x_psp = self.psp_module(ctx_full)
        x_trans, memory = self.model(x_fea, x_psp)

        # unflatten memory back to the three level maps (reference :265-279)
        spatial_shapes = tuple(tuple(f.shape[2:]) for f in x_fea)
        x_fpn = self.EFP(*tokens_to_levels(memory, spatial_shapes))

        # PSP-token re-broadcast to the context grid (reference :281-291);
        # under a shard, only the rank's rows of it are computed
        ctx_hw = ctx_full.shape[2:]
        resize = resize_bilinear if shard is None else shard.resize_rows
        cat, idx = [x_context], 0
        for s in self.psp_scales:
            pooled = x_trans[:, idx:idx + s * s].transpose(1, 2).reshape(bs, -1, s, s)
            cat.append(resize(pooled, ctx_hw, align_corners=True))
            idx += s * s
        # ViT's taps are all at stride 16: the fused pyramid goes to the 1/8
        # context grid (reference cswin_backbone.py:295-296); a ResNet's c2
        # is on it already
        fpn = resize_bilinear(x_fpn, ctx_hw, align_corners=False)
        cat.append(fpn if shard is None else shard.own_rows(fpn))
        main = self.uphead(self.cls_psp(torch.cat(cat, dim=1)))
        aux = self.auxlayer(aux_feat)
        if shard is not None:
            aux = shard.gather_rows(aux)
        full_h = x.shape[2] if shard is None else x.shape[2] * shard.world
        aux = resize(aux, (full_h, x.shape[3]), align_corners=True)
        return main, aux


def build_emrt(config, dtype=torch.float32) -> EMRT:
    """Build EMRT, any backbone variant, from a config node: MODEL.NAME
    containing 'EMRT_CSwin' / 'EMRT_ViT' / 'EMRT_HRNet' selects that backbone
    (reference registry, src/models/__init__.py:33-38), otherwise
    MODEL.ENCODER.TYPE decides; MODEL.TRANS shapes CSwin and ViT."""
    name = config.MODEL.NAME
    backbone = config.MODEL.ENCODER.TYPE
    for tag, variant in (("EMRT_CSwin", "CSwinTransformer"), ("EMRT_ViT", "ViT"),
                         ("EMRT_HRNet", "HRNet")):
        if tag in name:
            backbone = variant
            break
    trans = config.MODEL.TRANS
    heads = trans.NUM_HEADS
    crop_w, crop_h = (int(v) for v in config.DATA.CROP_SIZE)
    return EMRT(num_classes=config.DATA.NUM_CLASSES, backbone=backbone,
                output_stride=config.MODEL.OUTPUT_STRIDE,
                trans_embed_dim=trans.EMBED_DIM, trans_depths=tuple(trans.STAGE_DEPTHS),
                trans_heads=tuple(heads) if isinstance(heads, (list, tuple)) else (2, 4, 8, 16),
                trans_splits=tuple(trans.SPLIT_SIZES or (1, 2, 7, 7)),
                vit_hidden=trans.HIDDEN_SIZE, vit_layers=trans.NUM_LAYERS or 24,
                vit_heads=heads if isinstance(heads, int) else 16,
                vit_out_indices=tuple(config.MODEL.ENCODER.OUT_INDICES),
                img_size=(crop_h, crop_w), dtype=dtype)
