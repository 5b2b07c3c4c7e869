"""SegFormer (counterpart of ``emrt_tpu/models/segformer.py``; reference
src/models/segformer.py:20-53 and decoders/segformer_head.py:27-98).

The zoo MixViT (``backbones/mix_transformer.py::MixVisionTransformerZoo``)
and the SegformerHead: per stage a 1x1 conv-BN-ReLU to ``channels``
(``decode_head.convs.{i}``), each resized to the stride-4 map, concatenated
in stage order, fused by a 1x1 conv-BN-ReLU (``decode_head.fusion_conv``),
dropout 0.1, the 1x1 classifier ``conv_seg``, and a resize to 4x the
stride-4 map (not to the input's size: the two differ when the input is
no multiple of 4). forward(images) -> [logits], float32. Like the JAX
model, SegFormer names no ``decoder_lr_prefixes``: TRAIN.DECODER_LR_COEF
(10 in the ``mit-b*`` yamls) multiplies nothing.

Parameter names are the reference's (``segformer_key_map``):
``backbone.layers.*``, ``decode_head.{convs.{i},fusion_conv}.{conv,bn}``,
``decode_head.conv_seg``.

Under spatial parallelism (``parallel/spatial.py``, ``layers.ShardedWhole``)
the whole model runs on a rank's image rows: the MixViT's attentions over
the group's keys and values after the ``sr`` convs (k = stride = 8, 4, 2,
over the rank's rows alone, their count a multiple of k), its patch embeds
and ``pe_conv`` through halos, the head's resizes (by 2 to 8 to the
stride-4 map, then 4) through ``layers.upsample`` and its dropout a
``RowDropout``.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones.mix_transformer import MixVisionTransformerZoo
from .layers import BatchNorm2d, RowDropout, ShardedWhole, kaiming_normal_, sharded, upsample


class ConvModule(nn.Module):
    """1x1 conv (no bias) + BatchNorm (eps 1e-5) + ReLU, as ``conv`` and ``bn``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = kaiming_normal_(nn.Conv2d(cin, cout, 1, bias=False))
        self.bn = BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class SegformerHead(nn.Module):
    spatial = None

    def __init__(self, in_channels, channels: int = 256, num_classes: int = 60,
                 align_corners: bool = False):
        super().__init__()
        self.align_corners = align_corners
        self.convs = nn.ModuleList(ConvModule(c, channels) for c in in_channels)
        self.fusion_conv = ConvModule(channels * len(in_channels), channels)
        self.dropout = RowDropout(0.1)
        self.conv_seg = kaiming_normal_(nn.Conv2d(channels, num_classes, 1))

    def forward(self, feats):
        size0, shard = feats[0].shape[2:], sharded(self)
        outs = [upsample(conv(f), size0, shard, self.align_corners)
                for conv, f in zip(self.convs, feats)]
        out = self.conv_seg(self.dropout(self.fusion_conv(torch.cat(outs, 1))))
        return upsample(out, (4 * size0[0], 4 * size0[1]), shard, self.align_corners)


class Segformer(ShardedWhole, nn.Module):
    spatial_stride = 32                      # the last stage
    prefix_tokens = False

    def __init__(self, num_classes: int, embed_dims=(64, 128, 320, 512), depths=(3, 8, 27, 3),
                 num_heads=(1, 2, 5, 8), sr_ratios=(8, 4, 2, 1), mlp_ratio: float = 4.0,
                 head_channels: int = 256, align_corners: bool = False, dropout: float = 0.0,
                 drop_path: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = MixVisionTransformerZoo(embed_dims, depths, num_heads, sr_ratios,
                                                mlp_ratio, dropout, drop_path)
        self.decode_head = SegformerHead(embed_dims, head_channels, num_classes, align_corners)

    def spatial_deepest(self):
        """The last stage (its patch embed reads one row above at stride
        16), at stride 32."""
        return [self.backbone.layers[-1]]

    def forward(self, images):
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            out = self.decode_head(self.backbone(images))
        return [out.float()]


def build_segformer(config, dtype=torch.float32) -> Segformer:
    """As the JAX ``build_segformer``: the depths are TRANS.STAGE_DEPTHS
    (the ``mit-b*`` yamls' TRANS.NUM_LAYERS, EMBED_DIM and PATCH_SIZE go
    unread: ROADMAP.md queue 3, F9)."""
    trans = config.MODEL.TRANS
    return Segformer(
        num_classes=config.DATA.NUM_CLASSES,
        embed_dims=tuple(config.MODEL.SEGFORMER.IN_CHANNELS),
        depths=tuple(trans.STAGE_DEPTHS),
        num_heads=tuple(trans.NUM_HEADS or (1, 2, 5, 8)),
        sr_ratios=tuple(trans.SR_RATIOS),
        mlp_ratio=trans.MLP_RATIO or 4.0,
        head_channels=config.MODEL.SEGFORMER.CHANNELS,
        align_corners=config.MODEL.SEGFORMER.ALIGN_CORNERS,
        dropout=config.MODEL.DROPOUT,
        drop_path=config.MODEL.DROP_PATH,
        dtype=dtype)
