"""DETR-style sine and learned position embeddings and encoder reference
points (counterpart of ``emrt_tpu/models/position_encoding.py``).

The sine embedding and the reference points are host-side numpy tables per
static shape, exactly the JAX package's; ``sine_position_embedding`` and
``encoder_reference_points`` hand them over as tensors on the requested
device. ``LearnedPositionEmbedding`` is the transformer's
``position_embed_type="learned"``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn


@functools.lru_cache(maxsize=None)
def _sine_table(h: int, w: int, num_pos_feats: int, temperature: float,
                normalize: bool, offset: float, scale: float) -> np.ndarray:
    y_embed = np.tile(np.arange(1, h + 1, dtype=np.float64)[:, None], (1, w))
    x_embed = np.tile(np.arange(1, w + 1, dtype=np.float64)[None, :], (h, 1))
    eps = 1e-6
    if normalize:
        y_embed = (y_embed + offset) / (h + eps) * scale
        x_embed = (x_embed + offset) / (w + eps) * scale
    dim_t = 2 * (np.arange(num_pos_feats) // 2).astype(np.float64)
    dim_t = temperature ** (dim_t / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    # interleave sin(even) / cos(odd) exactly as the reference stack+flatten
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos = np.concatenate([pos_y, pos_x], axis=2)  # [h, w, 2*num_pos_feats]
    return pos.astype(np.float32)


def sine_position_embedding(h: int, w: int, num_pos_feats: int = 128,
                            device=None) -> torch.Tensor:
    """[h*w, 2*num_pos_feats] float32 sine/cosine position embedding (y-first),
    with the JAX package's defaults: temperature 1e4, normalized, offset -0.5."""
    table = _sine_table(h, w, num_pos_feats, 10000.0, True, -0.5, 2 * math.pi)
    return torch.from_numpy(table.reshape(h * w, -1)).to(device)


@functools.lru_cache(maxsize=None)
def _reference_points_table(spatial_shapes: tuple) -> np.ndarray:
    """Per-query normalized center coords, concatenated level-major.

    Equals TransformerEncoder.get_reference_points with all-valid ratios
    (reference transformer_encoder_decoder.py:213-228): for level (H, W) the
    grid is linspace(0.5, H-0.5, H)/H x linspace(0.5, W-0.5, W)/W, stacked
    (x, y), then broadcast to every level's coordinate frame.
    """
    refs = []
    for h, w in spatial_shapes:
        ref_y, ref_x = np.meshgrid(np.linspace(0.5, h - 0.5, h) / h,
                                   np.linspace(0.5, w - 0.5, w) / w,
                                   indexing="ij")
        refs.append(np.stack([ref_x.reshape(-1), ref_y.reshape(-1)], axis=-1))
    ref = np.concatenate(refs, axis=0)                     # [sum(hw), 2]
    n_levels = len(spatial_shapes)
    return np.tile(ref[:, None, :], (1, n_levels, 1)).astype(np.float32)


def encoder_reference_points(spatial_shapes, device=None) -> torch.Tensor:
    """[sum(HW), n_levels, 2] float32 static encoder reference points."""
    return torch.from_numpy(_reference_points_table(tuple(spatial_shapes))).to(device)


class LearnedPositionEmbedding(nn.Module):
    """Learned row and column tables of ``num_embeddings`` positions each
    (flax ``position_embedding/{row,col}_embed/embedding``, N(0, 1) at
    init): forward(h, w) -> [h*w, 2*num_pos_feats], pos(y, x) =
    concat(col[x], row[y]), x first, unlike the sine embedding's y first.
    A map larger than the tables raises, as the JAX module does."""

    def __init__(self, num_pos_feats: int = 128, num_embeddings: int = 50):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.row_embed = nn.Embedding(num_embeddings, num_pos_feats)
        self.col_embed = nn.Embedding(num_embeddings, num_pos_feats)

    def forward(self, h: int, w: int) -> torch.Tensor:
        if h > self.num_embeddings or w > self.num_embeddings:
            raise ValueError(
                f"LearnedPositionEmbedding table holds {self.num_embeddings} positions per "
                f"axis but the feature map is {h}x{w}; increase num_embeddings or use the "
                f"sine embedding")
        col = self.col_embed.weight[:w]
        row = self.row_embed.weight[:h]
        pos = torch.cat([col[None].expand(h, -1, -1), row[:, None].expand(-1, w, -1)], -1)
        return pos.reshape(h * w, -1)
