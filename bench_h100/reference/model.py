"""The reference EMRT: the published architecture (EMRT, IEEE TGRS 2023,
doi 10.1109/TGRS.2023.3256064) in plain PyTorch, float32, with no kernel,
no cache and no parallelism. Its module tree gives the parameter names the
measured program's checkpoints use, so one set of seeded weights loads
into both by name.

Backbones: ResNet-50 (bottleneck, 7x7 stem, output stride 32) or ViT
(patch 16, pre-norm blocks, taps at ``out_indices`` with a LayerNorm each,
the first of which feeds nothing). Then the spatial branch, the pyramid
pooling tokens, the deformable encoder (4 layers) and decoder (2 layers,
110 queries), the enhanced feature pyramid, the PSP re-broadcast, the
progressive-upsampling head and the auxiliary FCN head.

Numerics as the measured program's: LayerNorm and GroupNorm eps 1e-6,
BatchNorm eps 1e-5, GELU in its tanh form, the attention softmax and the
decoder's reference points in float32. Dropout draws its masks as the
program does (``ops.dropout``, ``ops.mask_dropout``), so that with the
default generator seeded alike both sides drop the same units.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .ops import (Precision, adaptive_avg_pool, deformable_core, dropout, level_tables,
                  mask_dropout, resize)

LN_EPS = 1e-6


class Conv(nn.Conv2d):
    def __init__(self, prec, cin, cout, k, stride=1, padding=None, dilation=1, bias=False):
        pad = dilation * (k // 2) if padding is None else padding
        super().__init__(cin, cout, k, stride, pad, dilation, bias=bias)
        self.prec = prec

    def forward(self, x):
        return self.prec.conv(x, self.weight, self.bias, self.stride, self.padding,
                              self.dilation, self.groups)


class Linear(nn.Linear):
    def __init__(self, prec, cin, cout, bias=True):
        super().__init__(cin, cout, bias=bias)
        self.prec = prec

    def forward(self, x):
        return self.prec.linear(x, self.weight, self.bias)


def conv_bn_relu(prec, cin, cout, k=3, stride=1, dilation=1):
    return [Conv(prec, cin, cout, k, stride, dilation=dilation),
            nn.BatchNorm2d(cout, eps=1e-5), nn.ReLU()]


class Pool(nn.Module):
    def __init__(self, size):
        super().__init__()
        self.size = size

    def forward(self, x):
        return adaptive_avg_pool(x, self.size)


class Dropout(nn.Module):
    """``ops.dropout`` (``whole=False``: drawn as ``F.dropout`` draws in
    ``draw_dtype``) or ``ops.mask_dropout`` (``whole=True``)."""

    def __init__(self, p, whole, draw_dtype):
        super().__init__()
        self.p, self.whole, self.draw_dtype = p, whole, draw_dtype

    def forward(self, x):
        if self.whole:
            return mask_dropout(x, self.p, self.training)
        return dropout(x, self.p, self.training, self.draw_dtype)


# -- ResNet-50 ---------------------------------------------------------------

class Bottleneck(nn.Module):
    def __init__(self, prec, cin, features, stride=1, dilation=1, downsample=False):
        super().__init__()
        self.conv1 = Conv(prec, cin, features, 1)
        self.bn1 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv2 = Conv(prec, features, features, 3, stride, dilation=dilation)
        self.bn2 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv3 = Conv(prec, features, features * 4, 1)
        self.bn3 = nn.BatchNorm2d(features * 4, eps=1e-5)
        self.downsample = (nn.Sequential(Conv(prec, cin, features * 4, 1, stride),
                                         nn.BatchNorm2d(features * 4, eps=1e-5))
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    """(c1, c2, c3, c4); output stride 32 only."""

    def __init__(self, prec, layers=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = Conv(prec, 3, 64, 7, 2)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        cin = 64
        for s, (features, blocks, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2)), start=1):
            mods = [Bottleneck(prec, cin, features, stride, downsample=True)]
            cin = features * 4
            mods += [Bottleneck(prec, cin, features) for _ in range(1, blocks)]
            setattr(self, f"layer{s}", nn.Sequential(*mods))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        c1 = self.layer1(x)
        c2 = self.layer2(c1)
        c3 = self.layer3(c2)
        return c1, c2, c3, self.layer4(c3)


# -- ViT -----------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, prec, dim, heads):
        super().__init__()
        self.prec, self.heads = prec, heads
        self.qkv = Linear(prec, dim, 3 * dim)
        self.out = Linear(prec, dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.heads
        q, k, v = self.qkv(x).view(b, n, 3, self.heads, hd).unbind(2)
        attn = self.prec.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k).float().softmax(-1)
        return self.out(self.prec.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, prec, dim, hidden):
        super().__init__()
        self.fc1 = Linear(prec, dim, hidden)
        self.fc2 = Linear(prec, hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class ViTLayer(nn.Module):
    def __init__(self, prec, dim, heads, mlp_ratio=4):
        super().__init__()
        self.attn_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(prec, dim, heads)
        self.mlp_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(prec, dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.attn_norm(x))
        return x + self.mlp(self.mlp_norm(x))


class Embeddings(nn.Module):
    def __init__(self, prec, img_size, patch, dim):
        super().__init__()
        self.grid = (img_size[0] // patch, img_size[1] // patch)
        self.patch_embeddings = Conv(prec, 3, dim, patch, patch, padding=0, bias=True)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.position_embeddings = nn.Parameter(torch.zeros(1, 1 + self.grid[0] * self.grid[1],
                                                            dim))

    def forward(self, x):
        x = self.patch_embeddings(x).flatten(2).transpose(1, 2)
        return torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], 1) + \
            self.position_embeddings


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class VisionTransformer(nn.Module):
    def __init__(self, prec, img_size, hidden, layers, heads, out_indices, patch=16):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.checkpoint = False     # recompute each block in the backward
        self.embeddings = Embeddings(prec, img_size, patch, hidden)
        self.encoder = _Layers(ViTLayer(prec, hidden, heads) for _ in range(layers))

    def forward(self, x):
        x = self.embeddings(x)
        gh, gw = self.embeddings.grid
        feats = []
        for i, layer in enumerate(self.encoder.layers):
            x = (checkpoint(layer, x, use_reentrant=False)
                 if self.checkpoint and self.training else layer(x))
            if i in self.out_indices:
                feats.append(x[:, -gh * gw:].transpose(1, 2).reshape(x.shape[0], -1, gh, gw))
        return feats


class ViTEncoder(nn.Module):
    def __init__(self, prec, **kw):
        super().__init__()
        self.transformer = VisionTransformer(prec, **kw)

    def forward(self, x):
        return self.transformer(x)


# -- deformable encoder-decoder ------------------------------------------------

class MSDeformableAttention(nn.Module):
    def __init__(self, prec, dim, heads, levels, points):
        super().__init__()
        self.dim, self.heads, self.levels, self.points = dim, heads, levels, points
        self.sampling_offsets = Linear(prec, dim, heads * levels * points * 2)
        self.attention_weights = Linear(prec, dim, heads * levels * points)
        self.value_proj = Linear(prec, dim, dim)
        self.output_proj = Linear(prec, dim, dim)

    def forward(self, query, ref, value, shapes):
        bs, len_q, _ = query.shape
        nh, nl, npt = self.heads, self.levels, self.points
        value = self.value_proj(value).view(bs, value.shape[1], nh, self.dim // nh)
        offsets = self.sampling_offsets(query).view(bs, len_q, nh, nl, npt, 2)
        attn = self.attention_weights(query).view(bs, len_q, nh, nl * npt)
        attn = attn.float().softmax(-1).view(bs, len_q, nh, nl, npt)
        norm = level_tables(shapes, self.dim, query.device)[2]
        loc = ref[:, :, None, :, None, :].float() + offsets.float() / norm[None, None, None,
                                                                         :, None, :]
        return self.output_proj(deformable_core(value, shapes, loc, attn))


class MultiHeadAttention(nn.Module):
    def __init__(self, prec, dim, heads, p, draw_dtype):
        super().__init__()
        self.prec, self.heads, self.p = prec, heads, p
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(prec, dim, dim)

    def forward(self, query, key, value):
        bs, len_q, e = query.shape
        hd = e // self.heads
        w_q, w_k, w_v = self.in_proj_weight.chunk(3)
        b_q, b_k, b_v = self.in_proj_bias.chunk(3)
        q = self.prec.linear(query, w_q, b_q).view(bs, len_q, self.heads, hd)
        k = self.prec.linear(key, w_k, b_k).view(bs, -1, self.heads, hd)
        v = self.prec.linear(value, w_v, b_v).view(bs, -1, self.heads, hd)
        attn = self.prec.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k).float().softmax(-1)
        attn = mask_dropout(attn, self.p, self.training)
        out = self.prec.einsum("bhqk,bkhd->bqhd", attn, v).reshape(bs, len_q, e)
        return self.out_proj(out)


def tokens_to_levels(tokens, shapes):
    bs, _, c = tokens.shape
    maps, start = [], 0
    for h, w in shapes:
        maps.append(tokens[:, start:start + h * w].transpose(1, 2).reshape(bs, c, h, w))
        start += h * w
    return maps


def levels_to_tokens(maps):
    return torch.cat([m.flatten(2).transpose(1, 2) for m in maps], dim=1)


class EncoderLayer(nn.Module):
    def __init__(self, prec, dim, heads, ffn, p, levels, points, draw_dtype):
        super().__init__()
        self.p = p
        self.self_attn = MSDeformableAttention(prec, dim, heads, levels, points)
        for i in range(levels):
            setattr(self, f"conv{i}", nn.Sequential(Conv(prec, dim, dim, 3),
                                                    nn.GroupNorm(32, dim, eps=LN_EPS)))
        self.linear1 = Linear(prec, dim, ffn)
        self.linear2 = Linear(prec, ffn, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.dropout = Dropout(p, False, draw_dtype)

    def ffn(self, x):
        return self.linear2(mask_dropout(F.relu(self.linear1(x)), self.p, self.training))

    def forward(self, src, ref, shapes, pos):
        convs = [getattr(self, f"conv{i}") for i in range(len(shapes))]
        src_conv = levels_to_tokens([F.gelu(c(m), approximate="tanh") + m
                                     for c, m in zip(convs, tokens_to_levels(src, shapes))])
        src2 = self.self_attn(src + pos, ref, src, shapes)
        src = self.norm1(src + self.dropout(src2))
        src = self.norm2(src + self.dropout(self.ffn(src)))
        return src + src_conv


class DecoderLayer(nn.Module):
    def __init__(self, prec, dim, heads, ffn, p, levels, points, draw_dtype):
        super().__init__()
        self.p = p
        self.self_attn = MultiHeadAttention(prec, dim, heads, p, draw_dtype)
        self.cross_attn = MSDeformableAttention(prec, dim, heads, levels, points)
        self.linear1 = Linear(prec, dim, ffn)
        self.linear2 = Linear(prec, ffn, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.dropout = Dropout(p, False, draw_dtype)

    def ffn(self, x):
        return self.linear2(mask_dropout(F.relu(self.linear1(x)), self.p, self.training))

    def forward(self, tgt, ref, memory, shapes, query_pos):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.dropout(self.self_attn(q, q, tgt)))
        tgt2 = self.cross_attn(tgt + query_pos, ref, memory, shapes)
        tgt = self.norm2(tgt + self.dropout(tgt2))
        return self.norm3(tgt + self.dropout(self.ffn(tgt)))


class EncoderDecoder(nn.Module):
    def __init__(self, prec, in_channels, queries, dim, heads, enc_layers, dec_layers,
                 points, p, draw_dtype, ffn=1024):
        super().__init__()
        levels = len(in_channels)
        self.dim = dim
        self.input_proj = nn.ModuleList(
            nn.Sequential(Conv(prec, c, dim, 1, bias=True), nn.GroupNorm(32, dim, eps=LN_EPS))
            for c in in_channels)
        self.level_embed = nn.Embedding(levels, dim)
        self.query_pos_embed = nn.Embedding(queries, dim)
        self.reference_points = nn.Linear(dim, 2)
        self.encoder = _Layers(EncoderLayer(prec, dim, heads, ffn, p, levels, points, draw_dtype)
                               for _ in range(enc_layers))
        self.decoder = _Layers(DecoderLayer(prec, dim, heads, ffn, p, levels, points, draw_dtype)
                               for _ in range(dec_layers))

    def forward(self, feats, src_psp):
        srcs = [proj(f) for proj, f in zip(self.input_proj, feats)]
        shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
        sine, ref_enc, _ = level_tables(shapes, self.dim, src_psp.device)
        level_pos = torch.cat([self.level_embed.weight[i].expand(h * w, -1)
                               for i, (h, w) in enumerate(shapes)])
        pos = (sine + level_pos)[None]
        memory = levels_to_tokens(srcs)
        for layer in self.encoder.layers:
            memory = layer(memory, ref_enc[None], shapes, pos)
        query_pos = self.query_pos_embed.weight[None].expand(memory.shape[0], -1, -1)
        ref = torch.sigmoid(self.reference_points(query_pos))     # float32 in both
        ref_dec = ref[:, :, None, :].expand(-1, -1, len(shapes), -1)
        tgt = src_psp
        for layer in self.decoder.layers:
            tgt = layer(tgt, ref_dec, memory, shapes, query_pos)
        return tgt, memory


# -- the heads and the assembly -------------------------------------------------

class Conv2dBlock(nn.Module):
    def __init__(self, prec, features):
        super().__init__()
        self.conv1 = nn.Sequential(*conv_bn_relu(prec, features, features))
        self.conv2 = nn.Sequential(*conv_bn_relu(prec, features, features))

    def forward(self, x):
        return self.conv2(self.conv1(x)) + x


class EFP(nn.Module):
    def __init__(self, prec, features=256):
        super().__init__()
        self.conv0 = Conv2dBlock(prec, features)
        self.conv1 = Conv2dBlock(prec, features)
        self.conv2 = Conv2dBlock(prec, features)

    def forward(self, x0, x1, x2):
        out2 = resize(self.conv2(x2), x1.shape[2:], align_corners=True)
        out21 = resize(self.conv1(x1) + out2, x0.shape[2:], align_corners=True)
        return self.conv0(x0) + out21


class Stage(nn.Module):
    def __init__(self, prec, cin, cout):
        super().__init__()
        self.encode = nn.Sequential(*conv_bn_relu(prec, cin, cout),
                                    *conv_bn_relu(prec, cout, cout))

    def forward(self, x):
        return self.encode(F.max_pool2d(x, 3, 2, 1))


class SpatialBranch(nn.Module):
    def __init__(self, prec):
        super().__init__()
        self.Enc0 = Stage(prec, 3, 64)
        self.Enc1 = Stage(prec, 64, 128)
        self.Enc2 = Stage(prec, 128, 256)

    def forward(self, x):
        return self.Enc2(self.Enc1(self.Enc0(x)))


class PyramidPooling(nn.Module):
    def __init__(self, prec, scales, channels=256):
        super().__init__()
        self.pool_branches = nn.ModuleList(
            nn.Sequential(Pool(s), *conv_bn_relu(prec, channels, channels, 1)) for s in scales)

    def forward(self, x):
        return torch.cat([b(x).flatten(2).transpose(1, 2) for b in self.pool_branches], dim=1)


class UpHead(nn.Module):
    def __init__(self, prec, classes):
        super().__init__()
        for i in range(3):
            setattr(self, f"conv_{i}", Conv(prec, 256, 256, 3, bias=True))
            setattr(self, f"syncbn_fc_{i}", nn.BatchNorm2d(256, eps=1e-5))
        self.conv_3 = Conv(prec, 256, classes, 1, bias=True)

    @staticmethod
    def _up(x):
        return resize(x, (2 * x.shape[2], 2 * x.shape[3]))

    def forward(self, x):
        for i in range(3):
            x = F.relu(getattr(self, f"syncbn_fc_{i}")(getattr(self, f"conv_{i}")(x)))
            if i < 2:
                x = self._up(x)
        return self._up(self.conv_3(x))


class FCNHead(nn.Module):
    def __init__(self, prec, cin, channels, classes, draw_dtype):
        super().__init__()
        self.convs = nn.ModuleList([nn.Sequential(*conv_bn_relu(prec, cin, channels))])
        self.dropout = Dropout(0.1, True, draw_dtype)
        self.conv_seg = Conv(prec, channels, classes, 1, bias=True)

    def forward(self, x):
        return self.conv_seg(self.dropout(self.convs[0](x)))


class EMRT(nn.Module):
    """forward(images [n, 3, H, W]) -> (main, aux) float32 logits at [H, W].

    ``spec``: the configuration file's ``model`` entry. ``draw_dtype``: the
    dtype of the measured program's activations at its ``F.dropout``
    sites (bfloat16 under its autocast)."""

    def __init__(self, spec: dict, prec: Precision | None = None,
                 draw_dtype: torch.dtype = torch.float32):
        super().__init__()
        prec = prec or Precision()
        self.psp_scales = tuple(spec["psp_scales"])
        p, classes = spec["dropout"], spec["num_classes"]
        if spec["backbone"] == "resnet50":
            if spec["output_stride"] != 32:
                raise NotImplementedError("the reference ResNet-50 runs at output stride 32")
            self.variant = "cnn"
            self.backbone = ResNet(prec)
            channels = [512, 1024, 2048]
        elif spec["backbone"] == "vit":
            vit = spec["vit"]
            self.variant = "taps"
            self.encoder = ViTEncoder(prec, img_size=tuple(spec["crop"]), hidden=vit["hidden"],
                                      layers=vit["layers"], heads=vit["heads"],
                                      out_indices=vit["out_indices"])
            n_taps = len(vit["out_indices"])
            self.layer_norms = nn.ModuleList(nn.LayerNorm(vit["hidden"], eps=LN_EPS)
                                             for _ in range(n_taps))
            channels = [vit["hidden"]] * (n_taps - 1)
        else:
            raise NotImplementedError(f"backbone {spec['backbone']}")
        aux = channels[1]
        tr = spec["transformer"]
        self.spatial_branch = SpatialBranch(prec)
        self.psp_module = PyramidPooling(prec, self.psp_scales)
        self.model = EncoderDecoder(prec, channels, sum(s * s for s in self.psp_scales),
                                    256, tr["heads"], tr["encoder_layers"], tr["decoder_layers"],
                                    tr["points"], p, draw_dtype)
        self.EFP = EFP(prec)
        self.cls_psp = nn.Sequential(
            *conv_bn_relu(prec, 256 * (2 + len(self.psp_scales)), 512),
            *conv_bn_relu(prec, 512, 256), Dropout(0.1, True, draw_dtype))
        self.uphead = UpHead(prec, classes)
        self.auxlayer = FCNHead(prec, aux, max(aux // 4, 16), classes, draw_dtype)

    def features(self, x):
        if self.variant == "cnn":
            _, c2, c3, c4 = self.backbone(x)
            return [c2, c3, c4], c3
        feats = [self.layer_norms[i](f.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                 for i, f in enumerate(self.encoder(x)) if i > 0]
        return feats, feats[1]

    def forward(self, x):
        bs = x.shape[0]
        feats, aux_feat = self.features(x)
        context = self.spatial_branch(x)
        x_trans, memory = self.model(feats, self.psp_module(context))
        shapes = tuple(tuple(f.shape[2:]) for f in feats)
        x_fpn = self.EFP(*tokens_to_levels(memory, shapes))
        hw = context.shape[2:]
        cat, idx = [context], 0
        for s in self.psp_scales:
            pooled = x_trans[:, idx:idx + s * s].transpose(1, 2).reshape(bs, -1, s, s)
            cat.append(resize(pooled, hw, align_corners=True))
            idx += s * s
        cat.append(resize(x_fpn, hw))
        main = self.uphead(self.cls_psp(torch.cat(cat, dim=1)))
        aux = resize(self.auxlayer(aux_feat), x.shape[2:], align_corners=True)
        return main.float(), aux.float()


def norm_parameters(model: nn.Module) -> set:
    """Names of the parameters that belong to a normalisation layer."""
    names = set()
    for mname, m in model.named_modules():
        if isinstance(m, (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)):
            names.update(f"{mname}.{p}" for p, _ in m.named_parameters(recurse=False))
    return names


def residual_norm_parameters(model: nn.Module) -> set:
    """Names of the parameters of the normalisation that ends a ResNet
    block's residual branch (``bn3`` of a bottleneck)."""
    return {f"{mname}.bn3.{p}" for mname, m in model.named_modules()
            if isinstance(m, Bottleneck) for p, _ in m.bn3.named_parameters()}
