"""Trans2Seg: transparent-object segmentation transformer (counterpart of
``emrt_tpu/models/trans2seg.py``; reference src/models/trans2seg.py:24-108,
backbones/trans2seg_transformer.py:84-421, decoders/trans2seg_head.py:21-130).

ResNet (``resnet50c`` at OUTPUT_STRIDE) features -> a Linear hybrid embed
-> a flat encoder with a cls token and a learned position table (made for
``img_size``) -> a class-prototype decoder whose per-class attention maps
join the encoder's features in a separable-conv head, with the stride-4 map
added. The reference's quirks, kept as the JAX package keeps them: the
decoder's doubled residuals (query = query2 + query2, feat = feat + feat,
attn = attn + attn), the pre-softmax logits as the returned maps, and
``fc_q``'s output reshaped head-major to [b, heads, n_class, head_dim] (not
a per-class split of the channels) with the attention output merged back
the same way: trained checkpoints depend on it.

Parameter names are the reference's (``trans2seg_key_map``):
``cnn_encoder.*``, ``hybrid_embed.proj``, ``transformer_encoder.{cls_token,
pos_embed, blocks_encoder.{i}.{norm1, attn.{qkv,proj}, norm2, mlp}, norm}``,
``transformer_decoder.{cls_embed, blocks_decoder.{i}.{norm1,
norm1_clsembed, norm2, norm3, norm4, attn.{fc_q,fc_kv,proj}, mlp, mlp2,
mlp3}}``, ``cnn_head.{lay1,lay2,lay3}.block.{depthwise, bn_depth,
pointwise, bn_point}``, ``cnn_head.conv_c1.{conv,bn}``, ``cnn_head.pred``.

Under spatial parallelism (``parallel/spatial.py``) the model has a sharded
region, the ResNet and the CNN head, which run on a rank's image rows (their
convs, the head's depthwise 3x3s too, through halos; their BatchNorms over
the gradient group), and a replicated one, the hybrid embed, the encoder
and the decoder, which run whole on every rank: the learned position table
covers the whole map, and the decoder's ``norm4`` / ``mlp3`` mix the
attention maps over all of their HW positions. The ResNet's c4 is gathered
(``SpatialShard.gather_rows``), and the features and attention maps are cut
to the rank's rows (``own_rows``) for the head, whose two align_corners=True
resizes (to c1, x2 or x4, and to the input, x4) go through
``layers.upsample``. Under tensor x spatial parallelism the encoder and
decoder are split over the model group (``parallel/tensor.py``) and run on
the maps each spatial group gathers.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones.resnet import backbone_channels, resnet
from .backbones.vit import Attention
from .layers import BatchNorm2d, Mlp, layer_norm, sharded, upsample, xavier_uniform_


def _trunc_normal(*shape):
    return nn.Parameter(nn.init.trunc_normal_(torch.empty(*shape), std=0.02, a=-0.04, b=0.04))


def _conv(cin, cout, k=1, groups=1, bias=False):
    return xavier_uniform_(nn.Conv2d(cin, cout, k, padding=k // 2, groups=groups, bias=bias))


class _EncoderAttention(Attention):
    """Self-attention with a bias-free fused ``qkv`` and a biased ``proj``:
    the ViT's ``Attention``, split over a model group as it is."""

    TP_SPLITS = {"qkv.weight": (0, 3), "proj.weight": (1, 1)}

    def __init__(self, dim: int, num_heads: int):
        super().__init__(dim, num_heads, qkv_bias=False)
        self.proj = self.out
        del self.out

    def forward(self, x):
        return self.project(self.attend(x), self.proj)


class _EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = _EncoderAttention(dim, num_heads)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class AttentionDecoder(nn.Module):
    """Class-prototype cross-attention -> (pre-softmax maps [b, n_class,
    heads, hw], the new query [b, n_class, dim])."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.fc_q = xavier_uniform_(nn.Linear(dim, dim, bias=False))
        self.fc_kv = xavier_uniform_(nn.Linear(dim, 2 * dim, bias=False))
        self.proj = xavier_uniform_(nn.Linear(dim, dim))

    def forward(self, q, x):
        b, n, c = x.shape
        n_class, nh = q.shape[1], self.num_heads
        hd = c // nh
        # head-major, as the reference: [b, n_class, c] read as [b, nh, n_class, hd]
        q = self.fc_q(q).reshape(b, nh, n_class, hd)
        k, v = self.fc_kv(x).view(b, n, 2, nh, hd).unbind(2)
        logits = torch.einsum("bhqd,bkhd->bhqk", q, k).float() * hd ** -0.5
        attn = logits.softmax(-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bhqd", attn, v).reshape(b, n_class, c)
        return logits.transpose(1, 2).to(v.dtype), self.proj(out)


class BlockDecoder(nn.Module):
    def __init__(self, dim: int, num_heads: int, feat_hw: int, mlp_ratio: float = 3.0):
        super().__init__()
        self.norm1_clsembed = layer_norm(dim)
        self.norm1 = layer_norm(dim)
        self.attn = AttentionDecoder(dim, num_heads)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.norm3 = layer_norm(dim)
        self.mlp2 = Mlp(dim, int(dim * mlp_ratio))
        self.norm4 = layer_norm(feat_hw)
        self.mlp3 = Mlp(feat_hw, feat_hw * 3)

    def forward(self, query, feat):
        attn, query2 = self.attn(self.norm1_clsembed(query), self.norm1(feat))
        query = query2 + query2
        query = query + self.mlp(self.norm2(query))
        feat = feat + feat
        feat = feat + self.mlp2(self.norm3(feat))
        attn = attn + attn
        attn = attn + self.mlp3(self.norm4(attn))
        return attn, query, feat


class SeparableConvBlock(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.depthwise = _conv(cin, cin, 3, groups=cin)
        self.bn_depth = BatchNorm2d(cin, eps=1e-5)
        self.pointwise = _conv(cin, features)
        self.bn_point = BatchNorm2d(features, eps=1e-5)

    def forward(self, x):
        x = F.relu(self.bn_depth(self.depthwise(x)))
        return F.relu(self.bn_point(self.pointwise(x)))


class _Wrap(nn.Module):
    """The reference's one-attribute wrappers (``lay{n}.block``,
    ``hybrid_embed.proj``)."""

    def __init__(self, name: str, module: nn.Module):
        super().__init__()
        self.name = name
        setattr(self, name, module)

    def forward(self, x):
        return getattr(self, self.name)(x)


class _ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _conv(cin, cout)
        self.bn = BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class _Encoder(nn.Module):
    def __init__(self, dim, depth, num_heads, mlp_ratio, n_tokens):
        super().__init__()
        self.cls_token = _trunc_normal(1, 1, dim)
        self.pos_embed = _trunc_normal(1, n_tokens + 1, dim)
        self.blocks_encoder = nn.ModuleList(_EncoderBlock(dim, num_heads, mlp_ratio)
                                            for _ in range(depth))
        self.norm = layer_norm(dim)

    def forward(self, tokens):
        if tokens.shape[1] + 1 != self.pos_embed.shape[1]:
            raise ValueError(f"{tokens.shape[1]} tokens, position table for "
                             f"{self.pos_embed.shape[1] - 1}: Trans2Seg takes one input size")
        cls = self.cls_token.expand(tokens.shape[0], -1, -1).to(tokens.dtype)
        x = torch.cat([cls, tokens], 1) + self.pos_embed.to(tokens.dtype)
        for block in self.blocks_encoder:
            x = block(x)
        return self.norm(x)


class _Decoder(nn.Module):
    def __init__(self, dim, depth, num_heads, mlp_ratio, n_tokens, num_classes):
        super().__init__()
        self.cls_embed = _trunc_normal(1, num_classes, dim)
        self.blocks_decoder = nn.ModuleList(BlockDecoder(dim, num_heads, n_tokens, mlp_ratio)
                                            for _ in range(depth))

    def forward(self, feat):
        cls_embed = self.cls_embed.expand(feat.shape[0], -1, -1).to(feat.dtype)
        query, attn = cls_embed, None
        for i, block in enumerate(self.blocks_decoder):
            if i > 0:
                query = query + cls_embed
            attn, query, feat = block(query, feat)
        return attn


class _CNNHead(nn.Module):
    def __init__(self, embed_dim, num_heads, hid_dim, c1_channels):
        super().__init__()
        self.lay1 = _Wrap("block", SeparableConvBlock(embed_dim + num_heads, hid_dim))
        self.lay2 = _Wrap("block", SeparableConvBlock(hid_dim, hid_dim))
        self.lay3 = _Wrap("block", SeparableConvBlock(hid_dim, hid_dim))
        self.conv_c1 = _ConvBN(c1_channels, hid_dim)
        self.pred = _conv(hid_dim, 1, bias=True)


def _stride_out(n: int, output_stride: int) -> int:
    """The ResNet's map size at ``output_stride`` for an input of n pixels
    (every stride-2 step pads so that it rounds up)."""
    for _ in range({8: 3, 16: 4, 32: 5}[output_stride]):
        n = (n + 1) // 2
    return n


class Trans2Seg(nn.Module):
    # a decoder block's norm4 / mlp3 refine an attention map that the next
    # block replaces, and the last block's attention projection, mlp and
    # mlp2 a query and features that nothing reads: DistributedDataParallel
    # must look for unused parameters
    ddp_find_unused_parameters = True
    spatial = None

    def __init__(self, num_classes: int, backbone: str = "resnet50c", output_stride: int = 16,
                 img_size=(512, 512), embed_dim: int = 256, depth: int = 4,
                 num_heads: int = 8, mlp_ratio: float = 3.0, hid_dim: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_classes, self.num_heads = num_classes, num_heads
        self.spatial_stride = output_stride
        self.cnn_encoder = resnet(50, backbone.endswith("c"), output_stride)
        c1, *_, c4 = backbone_channels(50)
        hw = _stride_out(img_size[0], output_stride) * _stride_out(img_size[1], output_stride)
        self.hybrid_embed = _Wrap("proj", xavier_uniform_(nn.Linear(c4, embed_dim)))
        self.transformer_encoder = _Encoder(embed_dim, depth, num_heads, mlp_ratio, hw)
        self.transformer_decoder = _Decoder(embed_dim, depth, num_heads, mlp_ratio, hw,
                                            num_classes)
        self.cnn_head = _CNNHead(embed_dim, num_heads, hid_dim, c1)

    def spatial_region(self):
        """The modules that run on a rank's rows under a spatial shard."""
        return (self.cnn_encoder, self.cnn_head)

    def spatial_deepest(self):
        """The ResNet's last stage, at the output stride."""
        return [self.cnn_encoder.layer4]

    def forward(self, images):
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            out = self._forward(images)
        return [out.float()]

    def _forward(self, x):
        c1, _, _, c4 = self.cnn_encoder(x)
        shard = sharded(self)
        if shard is not None:      # the rows of every rank, for the replicated region
            c4 = shard.gather_rows(c4)
        b, _, h, w = c4.shape
        nc, head = self.num_classes, self.cnn_head
        tokens = self.hybrid_embed(c4.flatten(2).transpose(1, 2))
        feat = self.transformer_encoder(tokens)[:, 1:]                 # [b, hw, dim]
        attn = self.transformer_decoder(feat)                          # [b, nc, heads, hw]
        amap = attn.reshape(b * nc, self.num_heads, h, w)
        fmap = feat.transpose(1, 2).reshape(b, -1, h, w)
        if shard is not None:
            amap, fmap = shard.own_rows(amap), shard.own_rows(fmap)
        fexp = fmap[:, None].expand(-1, nc, -1, -1, -1).reshape((b * nc,) + fmap.shape[1:])
        y = torch.cat([fexp, amap.to(fexp.dtype)], 1)
        y = head.lay2(head.lay1(y))
        y = upsample(y, c1.shape[2:], shard, align_corners=True)
        c1r = head.conv_c1(c1)
        y = y + c1r[:, None].expand(-1, nc, -1, -1, -1).reshape((b * nc,) + c1r.shape[1:])
        y = head.pred(head.lay3(y)).view(b, nc, *c1.shape[2:])
        return upsample(y, x.shape[2:], shard, align_corners=True)


def build_trans2seg(config, dtype=torch.float32) -> Trans2Seg:
    t = config.MODEL.TRANS2SEG
    crop_w, crop_h = (int(v) for v in config.DATA.CROP_SIZE)
    return Trans2Seg(num_classes=config.DATA.NUM_CLASSES,
                     backbone=config.MODEL.ENCODER.TYPE.lower(),
                     output_stride=config.MODEL.OUTPUT_STRIDE, img_size=(crop_h, crop_w),
                     embed_dim=t.EMBED_DIM, depth=t.DEPTH, num_heads=t.NUM_HEADS,
                     mlp_ratio=t.MLP_RATIO, hid_dim=t.HID_DIM, dtype=dtype)
