"""Common building blocks (counterpart of ``emrt_tpu/models/layers.py``).

NCHW modules whose parameter names follow the reference's Paddle layout, so
a ``.pdparams`` state dict maps onto them key for key (see
``utils/pdparams.py``). Initialisation follows the JAX package: Kaiming-normal
convs, Xavier-uniform projections, zero biases.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def kaiming_normal_(conv: nn.Conv2d) -> nn.Conv2d:
    nn.init.kaiming_normal_(conv.weight, mode="fan_in", nonlinearity="relu")
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)
    return conv


def xavier_uniform_(layer):
    nn.init.xavier_uniform_(layer.weight)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)
    return layer


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance follows flax's ``BatchNorm``.

    In train mode both normalise with the biased batch variance, but torch
    moves ``running_var`` toward the unbiased one (n / (n - 1) larger, n =
    N*H*W per channel; 8/7 for a 1x1 pooled map at batch 8) and flax toward
    the biased one. torch's update goes into a copy ``new`` (autograd keeps
    the tensor it was given for the backward, so that one must not change
    afterwards), and the buffer becomes ``(1 - m) * old + m * var_biased``
    = ``new - (new - (1 - m) * old) / n``. Eval mode and the state-dict keys
    are torch's.
    """

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        new = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, new, self.weight, self.bias, True,
                           self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.copy_(new - (new - (1.0 - self.momentum) * self.running_var) / n)
        return out


class ConvBNReLU(nn.Sequential):
    """conv(k, no bias) + BatchNorm(eps 1e-5) + ReLU, as ``[0]``, ``[1]``, ``[2]``
    (the reference's Sequential indices)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__(
            kaiming_normal_(nn.Conv2d(in_channels, out_channels, kernel_size,
                                      padding=kernel_size // 2, bias=False)),
            BatchNorm2d(out_channels, eps=1e-5),
            nn.ReLU(inplace=True))


class MultiHeadAttention(nn.Module):
    """Standard MHA over token sequences (reference layers.py:144-311).

    Fused ``in_proj_weight [3E, E]`` (q, k, v row blocks) and
    ``in_proj_bias [3E]`` as in the reference; scaled dot product with the
    softmax in float32, then ``out_proj``. Plain matmuls, as the JAX einsum.
    """

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        for w in self.in_proj_weight.data.chunk(3):
            nn.init.xavier_uniform_(w)
        self.out_proj = xavier_uniform_(nn.Linear(embed_dim, embed_dim))
        self.dropout = nn.Dropout(dropout)

    def forward(self, query, key=None, value=None):
        key = query if key is None else key
        value = key if value is None else value
        bs, len_q, e = query.shape
        head_dim = e // self.num_heads
        w_q, w_k, w_v = self.in_proj_weight.chunk(3)
        b_q, b_k, b_v = self.in_proj_bias.chunk(3)
        q = F.linear(query, w_q, b_q).view(bs, len_q, self.num_heads, head_dim)
        k = F.linear(key, w_k, b_k).view(bs, -1, self.num_heads, head_dim)
        v = F.linear(value, w_v, b_v).view(bs, -1, self.num_heads, head_dim)
        attn = torch.einsum("bqhd,bkhd->bhqk", q * head_dim ** -0.5, k)
        attn = self.dropout(attn.float().softmax(-1).to(v.dtype))
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(bs, len_q, e)
        return self.out_proj(out)
