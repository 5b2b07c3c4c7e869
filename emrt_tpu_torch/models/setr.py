"""SETR: SEgmentation TRansformer, MLA / PUP / Naive (counterpart of
``emrt_tpu/models/setr.py``; reference src/models/setr.py:28-170).

forward(images) -> [main, aux...] float32 logits at the input's size, in
the JAX package's order: the MLA head then ``aux_decoder2..5`` (one per MLA
map); the PUP head then ``aux_decoder2..5`` (one per ViT tap); the Naive
head then ``aux_decoder2..4`` (the first three taps). MixSoftmax weighs
every auxiliary output by AUX_WEIGHT, so the count and order are part of
the loss. ``decoder_lr_prefixes`` names the parameters that train at
TRAIN.DECODER_LR_COEF times the learning rate (reference setr.py:121-151):
the Paddle names of the JAX package's ``decoder`` / ``aux_decoder*``.

Under spatial parallelism (``parallel/spatial.py``, ``layers.ShardedWhole``)
the whole model runs on a rank's image rows: the ViT's attentions over the
group's keys and values, the cls token on spatial rank 0 alone (the MLA
encoder drops it there only), the heads' 3x3 convs through halos and their
resizes (align_corners False, and the MLA head's x4 with True) through
``layers.upsample``; at the deepest stride, the patch's 16, a rank needs a
row for the heads' 3x3 halos.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .backbones.vit import ViTEncoder
from .backbones.vit_mla import ViT_MLA
from .decoders.vit_mla_head import VIT_MLA_AUXIHead, VIT_MLAHead
from .decoders.vit_up_head import VisionTransformerUpHead
from .layers import ShardedWhole


class SETR(ShardedWhole, nn.Module):
    decoder_lr_prefixes = ("decoder", "aux_decoder")
    spatial_stride = 16                      # the patch

    def __init__(self, num_classes: int, encoder_type: str = "ViT_MLA",
                 decoder_type: str = "VIT_MLAHead", img_size=(512, 512), patch_size: int = 16,
                 hidden_size: int = 1024, num_layers: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, out_indices=(5, 11, 17, 23), mla_channels: int = 256,
                 mlahead_channels: int = 128, pup_num_conv: int = 4, pup_num_upsample: int = 4,
                 pup_conv3x3: bool = True, auxpup_num_conv: int = 2,
                 auxpup_num_upsample: int = 2, align_corners: bool = False,
                 auxihead: bool = True, dropout: float = 0.0, attn_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        vit = dict(img_size=tuple(img_size), patch_size=patch_size, hidden_size=hidden_size,
                   num_layers=num_layers, num_heads=num_heads, mlp_ratio=mlp_ratio,
                   out_indices=out_indices, dropout=dropout, attn_dropout=attn_dropout)
        self.mla = encoder_type == "ViT_MLA"
        self.encoder = (ViT_MLA(mla_channels=mla_channels, **vit) if self.mla
                        else ViTEncoder(**vit))
        n_aux = 0
        if decoder_type == "VIT_MLAHead":
            self.decoder = VIT_MLAHead(mla_channels, mlahead_channels, num_classes,
                                       align_corners)
            if auxihead:
                n_aux = 4
                aux = [VIT_MLA_AUXIHead(mla_channels, num_classes, align_corners)
                       for _ in range(n_aux)]
        else:
            self.decoder = VisionTransformerUpHead(hidden_size, num_classes, pup_num_conv,
                                                   pup_num_upsample, pup_conv3x3,
                                                   align_corners)
            if auxihead:
                n_aux = 4 if decoder_type.startswith("PUP") else 3
                aux = [VisionTransformerUpHead(hidden_size, num_classes, auxpup_num_conv,
                                               auxpup_num_upsample, pup_conv3x3,
                                               align_corners) for _ in range(n_aux)]
        self.n_aux = n_aux
        for i in range(n_aux):
            setattr(self, f"aux_decoder{i + 2}", aux[i])

    def spatial_deepest(self):
        """The modules that run at the patch grid: the encoder (with the MLA
        convs) and the heads, whose first convs read the grid."""
        return [self.encoder, self.decoder,
                *(getattr(self, f"aux_decoder{i + 2}") for i in range(self.n_aux))]

    def forward(self, images):
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            taps = self.encoder(images)
            preds = [self.decoder(*taps) if self.mla else self.decoder(taps[-1])]
            preds += [getattr(self, f"aux_decoder{i + 2}")(taps[i]) for i in range(self.n_aux)]
        return [p.float() for p in preds]


def build_setr(config, dtype=torch.float32) -> SETR:
    trans = config.MODEL.TRANS
    crop_w, crop_h = (int(v) for v in config.DATA.CROP_SIZE)
    return SETR(
        num_classes=config.DATA.NUM_CLASSES,
        encoder_type=config.MODEL.ENCODER.TYPE,
        decoder_type=config.MODEL.DECODER_TYPE,
        img_size=(crop_h, crop_w),
        patch_size=trans.PATCH_SIZE or 16,
        hidden_size=trans.HIDDEN_SIZE,
        num_layers=trans.NUM_LAYERS or 24,
        num_heads=trans.NUM_HEADS or 16,
        mlp_ratio=trans.MLP_RATIO or 4.0,
        out_indices=tuple(config.MODEL.ENCODER.OUT_INDICES),
        mla_channels=config.MODEL.MLA.MLA_CHANNELS,
        mlahead_channels=config.MODEL.MLA.MLAHEAD_CHANNELS,
        pup_num_conv=config.MODEL.PUP.NUM_CONV,
        pup_num_upsample=config.MODEL.PUP.NUM_UPSAMPLE_LAYER,
        pup_conv3x3=config.MODEL.PUP.CONV3x3_CONV1x1,
        auxpup_num_conv=config.MODEL.AUXPUP.NUM_CONV,
        auxpup_num_upsample=config.MODEL.AUXPUP.NUM_UPSAMPLE_LAYER,
        align_corners=config.MODEL.PUP.ALIGN_CORNERS,
        auxihead=config.MODEL.AUX.AUXIHEAD,
        dropout=config.MODEL.DROPOUT,
        attn_dropout=config.MODEL.ATTENTION_DROPOUT,
        dtype=dtype)
