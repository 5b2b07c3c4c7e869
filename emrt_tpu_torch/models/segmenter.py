"""Segmenter (counterpart of ``emrt_tpu/models/segmenter.py``; reference
src/models/segmentor.py:10-44 and decoders/segmentor_head.py:21-109).

A ViT (``encoder.transformer``, the port's ``backbones/vit.py``) or a DeiT
(``encoder``, ``backbones/deit.py``) whose last layer's grid tokens go
through the LayerNorm ``norm``, then a decoder:

* ``MaskTransformer``: ``proj_decoder``, the learned ``mask_tokens`` (one
  per class) appended to the patch tokens, transformer layers
  (``layers.{i}``, the ViT's ``EncoderLayer``), ``decoder_norm``, the
  bias-free ``proj_patch`` / ``proj_class``, both L2-normalised, their
  product (patch x class) and the LayerNorm ``mask_norm`` over the classes;
* ``LinearDecoder``: one Linear, ``head``.

The class masks, on the patch grid, are resized to the input (align_corners
False). forward(images) -> [logits], float32. Under bf16 autocast the L2
norms, the product's accumulation and the LayerNorms are float32, as in the
JAX package, where the random-weight classes are near ties that a bf16
product would flip. ``decoder_lr_prefixes``: ``decoder`` (reference
segmentor.py:33-44).

Under spatial parallelism (``parallel/spatial.py``, ``layers.ShardedWhole``)
the whole model runs on a rank's image rows: the encoder's attentions over
the group's keys and values, the prefix tokens (ViT's cls token, DeiT's
class and distillation tokens) on spatial rank 0 alone. The mask
transformer's class tokens run replicated on every rank, after the rank's
patch tokens, as the EMRT runs its replicated region: its attentions' queries
are the rank's patches and all the class tokens, their keys and values the
patches' gathered over the group and then the class tokens' from the rank's
own copy (``tail``; gathered, they would count once a rank). The product
``patches @ masks^T`` gives the rank's rows of the masks, which
``layers.upsample`` resizes to the rank's image rows.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .backbones.deit import DeiT
from .backbones.vit import Attention, EncoderLayer, ViTEncoder
from .layers import RowDropout, ShardedWhole, layer_norm, sharded, upsample, xavier_uniform_


class MaskTransformer(nn.Module):
    def __init__(self, hidden_size: int, num_classes: int, num_layers: int = 2,
                 num_heads: int = 16, mlp_ratio: float = 4.0):
        super().__init__()
        self.num_classes = num_classes
        self.proj_decoder = xavier_uniform_(nn.Linear(hidden_size, hidden_size))
        self.mask_tokens = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(1, num_classes, hidden_size), std=0.02, a=-0.04, b=0.04))
        self.layers = nn.ModuleList(EncoderLayer(hidden_size, num_heads, mlp_ratio)
                                    for _ in range(num_layers))
        # under a spatial shard the class tokens follow every rank's patches
        for m in self.layers.modules():
            if isinstance(m, (Attention, RowDropout)):
                m.tail = num_classes
        self.decoder_norm = layer_norm(hidden_size)
        self.proj_patch = nn.Linear(hidden_size, hidden_size, bias=False)
        self.proj_class = nn.Linear(hidden_size, hidden_size, bias=False)
        for proj in (self.proj_patch, self.proj_class):
            nn.init.normal_(proj.weight, std=hidden_size ** -0.5)
        self.mask_norm = layer_norm(num_classes)

    def forward(self, x):
        x = self.proj_decoder(x)
        x = torch.cat([x, self.mask_tokens.expand(x.shape[0], -1, -1).to(x.dtype)], 1)
        for layer in self.layers:
            x = layer(x)
        x = self.decoder_norm(x)
        patches = self.proj_patch(x[:, :-self.num_classes])
        masks = self.proj_class(x[:, -self.num_classes:])
        with torch.autocast(x.device.type, enabled=False):
            # as the JAX decoder: each row over its norm, taken in float32 and
            # cast to the rows' type, then the product accumulated in float32
            patches = patches / patches.float().norm(dim=-1, keepdim=True).to(patches.dtype)
            masks = masks / masks.float().norm(dim=-1, keepdim=True).to(masks.dtype)
            return self.mask_norm(patches.float() @ masks.float().transpose(1, 2))


class LinearDecoder(nn.Module):
    def __init__(self, hidden_size: int, num_classes: int):
        super().__init__()
        self.head = xavier_uniform_(nn.Linear(hidden_size, num_classes))

    def forward(self, x):
        return self.head(x)


class Segmenter(ShardedWhole, nn.Module):
    decoder_lr_prefixes = ("decoder",)
    spatial_stride = 16                      # the patch

    def __init__(self, num_classes: int, decoder_type: str = "MaskTransformer",
                 img_size=(512, 512), patch_size: int = 16, hidden_size: int = 384,
                 num_layers: int = 12, num_heads: int = 6, mlp_ratio: float = 4.0,
                 seg_num_layers: int = 2, distilled: bool = False, dropout: float = 0.0,
                 attn_dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        vit = dict(img_size=tuple(img_size), patch_size=patch_size, hidden_size=hidden_size,
                   num_layers=num_layers, num_heads=num_heads, mlp_ratio=mlp_ratio,
                   dropout=dropout, attn_dropout=attn_dropout)
        self.encoder = (DeiT(**vit) if distilled
                        else ViTEncoder(out_indices=(num_layers - 1,), **vit))
        self.norm = layer_norm(hidden_size)
        self.decoder = (LinearDecoder(hidden_size, num_classes) if "Linear" in decoder_type
                        else MaskTransformer(hidden_size, num_classes, seg_num_layers,
                                             num_heads, mlp_ratio))

    def spatial_deepest(self):
        """The modules at the patch grid: the encoder (its patch embed reads
        no halo) and the decoder (no conv)."""
        return [self.encoder, self.decoder]

    def forward(self, images):
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            grid = self.encoder(images)[-1]
            b, _, gh, gw = grid.shape
            masks = self.decoder(self.norm(grid.flatten(2).transpose(1, 2)))
            masks = masks.transpose(1, 2).reshape(b, -1, gh, gw)
            out = upsample(masks, images.shape[2:], sharded(self))
        return [out.float()]


def build_segmenter(config, dtype=torch.float32) -> Segmenter:
    """As the JAX ``build_segmenter``: DeiT when "DeiT" is in ENCODER.TYPE,
    the linear decoder when "Linear" is in DECODER_TYPE; the yamls'
    KEEP_CLS_TOKEN and OUT_INDICES go unread there and here."""
    trans = config.MODEL.TRANS
    crop_w, crop_h = (int(v) for v in config.DATA.CROP_SIZE)
    return Segmenter(
        num_classes=config.DATA.NUM_CLASSES,
        decoder_type=config.MODEL.DECODER_TYPE,
        img_size=(crop_h, crop_w),
        patch_size=trans.PATCH_SIZE or 16,
        hidden_size=trans.HIDDEN_SIZE,
        num_layers=trans.NUM_LAYERS or 12,
        num_heads=trans.NUM_HEADS or 6,
        mlp_ratio=trans.MLP_RATIO or 4.0,
        seg_num_layers=config.MODEL.SEGMENTER.NUM_LAYERS,
        distilled="DeiT" in config.MODEL.ENCODER.TYPE,
        dropout=config.MODEL.DROPOUT,
        attn_dropout=config.MODEL.ATTENTION_DROPOUT,
        dtype=dtype)
