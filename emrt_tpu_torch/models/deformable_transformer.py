"""Multi-scale deformable-attention encoder-decoder (counterpart of
``emrt_tpu/models/deformable_transformer.py``).

Tokens live as [bs, sum(HW), C] with each level flattened row-major (h, w);
level maps are NCHW. Parameter names follow the reference's Paddle module
tree (transformer_encoder_decoder.py:21-473): ``encoder.layers.N``,
``decoder.layers.N``, ``input_proj.N``, ``level_embed``, ``query_pos_embed``,
``reference_points``.

Numerics follow the JAX package, not Paddle: LayerNorm and GroupNorm use
flax's default eps 1e-6 where Paddle uses 1e-5 (an open question in
ROADMAP.md queue 3), GELU is the tanh form (flax's default), the attention
softmax and the decoder reference points run in float32.

Split over a model group (``parallel/tensor.py``, PARALLEL.MODEL = T), as
the JAX package's ``tp_rule`` places them: ``MSDeformableAttention`` runs
head-parallel (``value_proj``'s output rows and ``output_proj``'s input
columns of the rank's nh/T heads; the offsets and attention weights of its
heads from the replicated ``sampling_offsets`` / ``attention_weights``,
whose rows are head-major), so the deformable core runs at nh/T heads; the
layers' FFNs split ``linear1``'s output rows and ``linear2``'s input
columns; the decoder's ``MultiHeadAttention`` splits by heads.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deformable import deformable_attention, deformable_attention_core
from .layers import NORM_EPS, MultiHeadAttention, layer_norm, split_dropout, xavier_uniform_
from .position_encoding import encoder_reference_points, sine_position_embedding


def _offset_bias_init(num_heads: int, num_levels: int, num_points: int) -> np.ndarray:
    """Rotated-grid bias (reference transformer_encoder_decoder.py:46-55)."""
    thetas = np.arange(num_heads, dtype=np.float64) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(num_heads, 1, 1, 2), (1, num_levels, num_points, 1))
    scaling = np.arange(1, num_points + 1, dtype=np.float64).reshape(1, 1, -1, 1)
    grid = grid * scaling
    return grid.reshape(-1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _level_tables(spatial_shapes: tuple, hidden_dim: int, device: torch.device):
    """Constant per-geometry tables on ``device``: sine position embedding
    [sum(HW), C], encoder reference points [sum(HW), L, 2] and the (W, H)
    offset normalizer [L, 2]. Made outside inference mode even when the
    first call comes from an eval under ``torch.inference_mode``: autograd
    refuses to save inference tensors, and training uses the same tables."""
    with torch.inference_mode(False):
        pos = torch.cat([sine_position_embedding(h, w, hidden_dim // 2)
                         for h, w in spatial_shapes])
        ref = encoder_reference_points(spatial_shapes)
        norm = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32)
        return pos.to(device), ref.to(device), norm.to(device)


class MSDeformableAttention(nn.Module):
    """Multi-scale deformable attention (reference :21-107).

    ``use_kernel`` picks the core: True (the default) dispatches through
    ``ops.deformable.deformable_attention`` (CUDA kernels on CUDA tensors, the
    plain version on CPU tensors); False always runs the plain version
    (``models.get_model(..., use_kernel=False)`` sets it).

    Split over a model group (``tp``, ``parallel/tensor.py``) it runs the
    rank's nh/T heads: ``value_proj`` holds their output rows,
    ``output_proj`` their input columns (its bias is added once, after the
    group's sum); the offsets and weights are the rank's rows of the
    replicated projections, head-major ``(h, l, p[, 2])``.
    """

    TP_SPLITS = {"value_proj.weight": (0, 1), "output_proj.weight": (1, 1)}
    TP_PARTIAL = ("sampling_offsets.weight", "sampling_offsets.bias",
                  "attention_weights.weight", "attention_weights.bias", "value_proj.bias")
    tp = None

    def __init__(self, embed_dim: int = 256, num_heads: int = 8,
                 num_levels: int = 3, num_points: int = 4):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        self.use_kernel = True
        total_points = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(embed_dim, total_points * 2)
        self.attention_weights = nn.Linear(embed_dim, total_points)
        self.value_proj = xavier_uniform_(nn.Linear(embed_dim, embed_dim))
        self.output_proj = xavier_uniform_(nn.Linear(embed_dim, embed_dim))
        nn.init.zeros_(self.sampling_offsets.weight)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(torch.from_numpy(
                _offset_bias_init(num_heads, num_levels, num_points)))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)

    def tp_dims(self) -> dict:
        return {"heads": self.num_heads}

    def _rows(self, linear):
        """The weight and bias rows of this rank's heads (all of them
        unsplit)."""
        if self.tp is None:
            return linear.weight, linear.bias
        rows = self.tp.rows(linear.out_features)
        return linear.weight[rows], linear.bias[rows]

    def forward(self, query, reference_points, value, spatial_shapes):
        """query [bs, Lq, C]; reference_points [bs or 1, Lq, L, 2] in [0, 1];
        value [bs, Lv, C]; spatial_shapes static ((H, W), ...)."""
        bs, len_q, _ = query.shape
        len_v = value.shape[1]
        tp = self.tp
        nl, npt = self.num_levels, self.num_points
        nh = self.num_heads // (tp.world if tp is not None else 1)
        if tp is not None:   # the decoder's reference points are learned: copied in too
            query, value = tp.copy_in(query), tp.copy_in(value)
            reference_points = tp.copy_in(reference_points)
        bias = self.value_proj.bias if tp is None else self.value_proj.bias[
            tp.rows(self.embed_dim)]
        value = F.linear(value, self.value_proj.weight, bias).view(
            bs, len_v, nh, self.embed_dim // self.num_heads)
        offsets = F.linear(query, *self._rows(self.sampling_offsets)).view(
            bs, len_q, nh, nl, npt, 2)
        attn = F.linear(query, *self._rows(self.attention_weights)).view(bs, len_q, nh, nl * npt)
        attn = attn.float().softmax(-1).view(bs, len_q, nh, nl, npt).to(value.dtype)
        normalizer = _level_tables(tuple(spatial_shapes), self.embed_dim,
                                   query.device)[2]
        loc = (reference_points[:, :, None, :, None, :].float()
               + offsets.float() / normalizer[None, None, None, :, None, :])
        core = deformable_attention if self.use_kernel else deformable_attention_core
        out = core(value.contiguous(), tuple(spatial_shapes), loc.contiguous(),
                   attn.contiguous())
        if tp is None:
            return self.output_proj(out)
        return tp.reduce_out(F.linear(out, self.output_proj.weight), self.output_proj.bias)


def tokens_to_levels(tokens, spatial_shapes):
    """[bs, sum(HW), C] -> list of [bs, C, H, W] maps (reference seq2_2D)."""
    bs, _, c = tokens.shape
    maps, start = [], 0
    for h, w in spatial_shapes:
        maps.append(tokens[:, start:start + h * w].transpose(1, 2).reshape(bs, c, h, w))
        start += h * w
    return maps


def levels_to_tokens(maps):
    """list of [bs, C, H, W] -> [bs, sum(HW), C], row-major (h, w)."""
    return torch.cat([m.flatten(2).transpose(1, 2) for m in maps], dim=1)


def conv_enhance(convs, tokens, spatial_shapes):
    """Per-level 3x3 conv + GroupNorm(32) + GELU with residual: the JAX
    package's ``ConvEnhance`` (reference TransformerEncoderLayer conv0/1/2,
    :125-144, :187-189). Its convs live on the encoder layer as ``conv0..2``,
    where the reference keeps them."""
    outs = []
    for conv, m in zip(convs, tokens_to_levels(tokens, spatial_shapes)):
        outs.append(F.gelu(conv(m), approximate="tanh") + m)
    return levels_to_tokens(outs)


class _SplitFFN:
    """The FFN of an encoder or decoder layer, ``linear2(dropout(relu(
    linear1(x))))``. Split over a model group (``tp``), a rank holds
    ``linear1``'s rows and ``linear2``'s columns of its 1/T of the hidden
    width; ``linear1``'s bias stays replicated (as ``tp_rule`` leaves it)
    and is read on the rank's rows, ``linear2``'s is added once after the
    group's sum."""

    TP_SPLITS = {"linear1.weight": (0, 1), "linear2.weight": (1, 1)}
    TP_PARTIAL = ("linear1.bias",)
    tp = None

    def tp_dims(self) -> dict:
        return {"FFN hidden units": self.linear1.out_features}

    def ffn(self, x):
        tp = self.tp
        bias = self.linear1.bias
        if tp is not None:
            x, bias = tp.copy_in(x), bias[tp.rows(bias.numel())]
        h = F.relu(F.linear(x, self.linear1.weight, bias))
        h = split_dropout(h, self.dropout.p, self.training, -1, tp)
        if tp is None:
            return self.linear2(h)
        return tp.reduce_out(F.linear(h, self.linear2.weight), self.linear2.bias)


class EncoderLayer(_SplitFFN, nn.Module):
    """Deformable self-attn + FFN + conv-branch fusion (reference :109-204)."""

    def __init__(self, d_model: int = 256, n_head: int = 8,
                 dim_feedforward: int = 1024, dropout: float = 0.1,
                 n_levels: int = 3, n_points: int = 4):
        super().__init__()
        self.self_attn = MSDeformableAttention(d_model, n_head, n_levels, n_points)
        for i in range(n_levels):   # ConvEnhance's convs, under the reference's names
            setattr(self, f"conv{i}", nn.Sequential(
                xavier_uniform_(nn.Conv2d(d_model, d_model, 3, padding=1, bias=False)),
                nn.GroupNorm(32, d_model, eps=NORM_EPS)))
        self.linear1 = xavier_uniform_(nn.Linear(d_model, dim_feedforward))
        self.linear2 = xavier_uniform_(nn.Linear(dim_feedforward, d_model))
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, src, reference_points, spatial_shapes, pos_embed):
        convs = [getattr(self, f"conv{i}") for i in range(len(spatial_shapes))]
        src_conv = conv_enhance(convs, src, spatial_shapes)
        src2 = self.self_attn(src + pos_embed, reference_points, src, spatial_shapes)
        src = self.norm1(src + self.dropout(src2))
        src = self.norm2(src + self.dropout(self.ffn(src)))
        return src + src_conv


class DecoderLayer(_SplitFFN, nn.Module):
    """MHSA over queries + deformable cross-attn + FFN (reference :242-295)."""

    def __init__(self, d_model: int = 256, n_head: int = 8,
                 dim_feedforward: int = 1024, dropout: float = 0.1,
                 n_levels: int = 3, n_points: int = 4):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_head, dropout)
        self.cross_attn = MSDeformableAttention(d_model, n_head, n_levels, n_points)
        self.linear1 = xavier_uniform_(nn.Linear(d_model, dim_feedforward))
        self.linear2 = xavier_uniform_(nn.Linear(dim_feedforward, d_model))
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.norm3 = layer_norm(d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, tgt, reference_points, memory, spatial_shapes, query_pos):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.dropout(self.self_attn(q, q, tgt)))
        tgt2 = self.cross_attn(tgt + query_pos, reference_points, memory,
                               spatial_shapes)
        tgt = self.norm2(tgt + self.dropout(tgt2))
        return self.norm3(tgt + self.dropout(self.ffn(tgt)))


class _Layers(nn.Module):
    """Holds ``layers.N`` (the reference's TransformerEncoder/Decoder)."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class EncoderDecoder(nn.Module):
    """Full deformable encoder-decoder (reference :337-473).

    forward(src_feats, src_psp): src_feats is a list of NCHW backbone maps
    (c2, c3, c4), src_psp is [bs, n_queries, C] pooled tokens used as the
    decoder's tgt. Returns (hs [bs, n_queries, C], memory [bs, sum(HW), C]).
    """

    def __init__(self, in_channels, num_queries: int = 110, hidden_dim: int = 256,
                 nhead: int = 8, num_encoder_layers: int = 4,
                 num_decoder_layers: int = 2, num_encoder_points: int = 6,
                 num_decoder_points: int = 6, dim_feedforward: int = 1024,
                 dropout: float = 0.1):
        super().__init__()
        n_levels = len(in_channels)
        self.hidden_dim = hidden_dim
        self.input_proj = nn.ModuleList(
            nn.Sequential(xavier_uniform_(nn.Conv2d(c, hidden_dim, 1)),
                          nn.GroupNorm(32, hidden_dim, eps=NORM_EPS))
            for c in in_channels)
        self.level_embed = nn.Embedding(n_levels, hidden_dim)
        self.query_pos_embed = nn.Embedding(num_queries, hidden_dim)
        self.reference_points = xavier_uniform_(nn.Linear(hidden_dim, 2))
        self.encoder = _Layers(
            EncoderLayer(hidden_dim, nhead, dim_feedforward, dropout, n_levels,
                         num_encoder_points)
            for _ in range(num_encoder_layers))
        self.decoder = _Layers(
            DecoderLayer(hidden_dim, nhead, dim_feedforward, dropout, n_levels,
                         num_decoder_points)
            for _ in range(num_decoder_layers))

    def forward(self, src_feats, src_psp):
        srcs = [proj(f) for proj, f in zip(self.input_proj, src_feats)]
        spatial_shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
        sine, ref_enc, _ = _level_tables(spatial_shapes, self.hidden_dim,
                                         src_psp.device)
        sizes = [h * w for h, w in spatial_shapes]
        level_pos = torch.cat([self.level_embed.weight[lvl].expand(n, -1)
                               for lvl, n in enumerate(sizes)])
        pos_embed = (sine + level_pos)[None]                    # [1, sum, C]

        memory = levels_to_tokens(srcs)
        for layer in self.encoder.layers:
            memory = layer(memory, ref_enc[None], spatial_shapes, pos_embed)

        bs = memory.shape[0]
        query_pos = self.query_pos_embed.weight[None].expand(bs, -1, -1)
        # decoder reference points: sigmoid(Linear(query_pos)) in float32
        # (reference :466), outside any autocast
        with torch.autocast(query_pos.device.type, enabled=False):
            ref = torch.sigmoid(F.linear(query_pos.float(),
                                         self.reference_points.weight.float(),
                                         self.reference_points.bias.float()))
        ref_dec = ref[:, :, None, :].expand(-1, -1, len(spatial_shapes), -1)

        tgt = src_psp
        for layer in self.decoder.layers:
            tgt = layer(tgt, ref_dec, memory, spatial_shapes, query_pos)
        return tgt, memory
