"""UperNet with a Swin, CSwin or Focal backbone (counterpart of
``emrt_tpu/models/upernet.py``; reference src/models/upernet.py:30-102).

The backbone's four stage maps, each through its LayerNorm
(``layer_norms.{s}``), feed the UperHead (``decoder``) and, the third, the
FCN auxiliary head (``aux_decoder``, one conv-BN-ReLU of 256 channels at
the map's resolution: the JAX package builds it with up_ratio 1 whatever
AUXFCN.UP_RATIO says, and so does the port); both are resized to the
input. forward(images) -> [main, aux] float32 logits. The JAX UperNet names
no decoder-learning-rate prefixes, so TRAIN.DECODER_LR_COEF changes
nothing here either.

Under spatial parallelism (``parallel/spatial.py``, ``layers.ShardedWhole``)
the whole model runs on a rank's image rows: the backbone's window, stripe
or focal attentions over the map gathered from the group, its patch
embeds and merges on the rank's rows (CSwin's and the ``useconv`` Focal's
convs through halos), the UperHead as ``decoders/uper_head.py`` says, the
aux head through halos, and both resizes to the input through
``layers.upsample``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .backbones.cswin import CSwinTransformer
from .backbones.focal import FocalTransformer
from .backbones.swin import SwinTransformer
from .decoders.fcn_head import FCNHead
from .decoders.uper_head import UperHead
from .layers import ShardedWhole, layer_norm, sharded, upsample


class UperNet(ShardedWhole, nn.Module):
    spatial_stride = 32                      # the last stage
    prefix_tokens = False

    def __init__(self, num_classes: int, encoder_type: str = "SwinTransformer",
                 img_size=(512, 512), embed_dim: int = 96, depths=(2, 2, 6, 2),
                 num_heads=(3, 6, 12, 24), window_size: int = 7, split_sizes=None,
                 expand_sizes=None, focal_levels=None, focal_windows=None, focal_stages=None,
                 use_conv_embed: bool = False, qkv_bias: bool = True, mlp_ratio: float = 4.0,
                 pool_scales=(1, 2, 3, 6), uper_channels: int = 512, aux_channels: int = 256,
                 auxihead: bool = True, drop_path: float = 0.2, dropout: float = 0.0,
                 attn_dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        img_size = tuple(img_size)
        if encoder_type == "SwinTransformer":
            self.encoder = SwinTransformer(
                img_size, embed_dim=embed_dim, depths=depths, num_heads=num_heads,
                window_size=window_size, mlp_ratio=mlp_ratio, dropout=dropout,
                attn_dropout=attn_dropout, drop_path_rate=drop_path)
        elif encoder_type == "CSwinTransformer":
            self.encoder = CSwinTransformer(embed_dim, depths, num_heads,
                                            split_sizes or (1, 2, 7, 7), mlp_ratio,
                                            drop_path_rate=drop_path)
        elif encoder_type == "FocalTransformer":
            self.encoder = FocalTransformer(
                img_size, embed_dim=embed_dim, depths=depths, num_heads=num_heads,
                window_size=window_size, expand_sizes=expand_sizes or (3, 3, 3, 3),
                focal_levels=focal_levels or (2, 2, 2, 2),
                focal_windows=focal_windows or (7, 5, 3, 1),
                focal_stages=focal_stages or (0, 1, 2, 3), mlp_ratio=mlp_ratio,
                qkv_bias=qkv_bias, use_conv_embed=use_conv_embed, dropout=dropout,
                attn_dropout=attn_dropout, drop_path_rate=drop_path)
        else:
            raise NotImplementedError(encoder_type)
        channels = [embed_dim * 2 ** i for i in range(len(depths))]
        self.layer_norms = nn.ModuleList(layer_norm(c) for c in channels)
        self.decoder = UperHead(channels, pool_scales, uper_channels, num_classes)
        self.aux_decoder = FCNHead(channels[2], aux_channels, num_classes) if auxihead else None

    def spatial_deepest(self):
        """The pyramid pooling's ``bottleneck`` (3x3, one row a side): the
        one conv at stride 32 (the backbones' last stages have none)."""
        return [self.decoder.bottleneck]

    def forward(self, images):
        size, shard = images.shape[2:], sharded(self)
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            feats = [norm(f.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                     for norm, f in zip(self.layer_norms, self.encoder(images))]
            preds = [upsample(self.decoder(feats), size, shard)]
            if self.aux_decoder is not None:
                preds.append(upsample(self.aux_decoder(feats[2]), size, shard))
        return [p.float() for p in preds]


def build_upernet(config, dtype=torch.float32) -> UperNet:
    trans = config.MODEL.TRANS
    crop_w, crop_h = (int(v) for v in config.DATA.CROP_SIZE)

    def opt(v):
        return tuple(v) if v else None

    return UperNet(
        num_classes=config.DATA.NUM_CLASSES,
        encoder_type=config.MODEL.ENCODER.TYPE,
        img_size=(crop_h, crop_w),
        embed_dim=trans.EMBED_DIM,
        depths=tuple(trans.STAGE_DEPTHS),
        num_heads=tuple(trans.NUM_HEADS or (3, 6, 12, 24)),
        window_size=trans.WINDOW_SIZE or 7,
        split_sizes=opt(trans.SPLIT_SIZES),
        expand_sizes=opt(trans.EXPAND_SIZES),
        focal_levels=opt(trans.FOCAL_LEVELS),
        focal_windows=opt(trans.FOCAL_WINDOWS),
        focal_stages=opt(trans.FOCAL_STAGES),
        use_conv_embed=bool(trans.USE_CONV_EMBED),
        qkv_bias=bool(trans.QKV_BIAS),
        mlp_ratio=trans.MLP_RATIO or 4.0,
        pool_scales=tuple(config.MODEL.UPERHEAD.POOL_SCALES),
        uper_channels=config.MODEL.UPERHEAD.CHANNELS,
        auxihead=config.MODEL.AUX.AUXIHEAD,
        drop_path=config.MODEL.DROP_PATH,
        dropout=config.MODEL.DROPOUT,
        attn_dropout=config.MODEL.ATTENTION_DROPOUT,
        dtype=dtype)
