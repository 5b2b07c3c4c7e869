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

from ..ops.pooling import adaptive_avg_pool
from ..ops.resize import resize_bilinear


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


class _FlaxRunningVar:
    """Running variance as flax's ``BatchNorm`` keeps it.

    In train mode both normalise with the biased batch variance, but torch
    moves ``running_var`` toward the unbiased one (n / (n - 1) larger, n =
    the values per channel: N*H*W of a map, N of a vector; 8/7 for a 1x1
    pooled map at batch 8) and flax toward the biased one. torch's update
    goes into a copy ``new`` (autograd keeps the tensor it was given for the
    backward, so that one must not change afterwards), and the buffer
    becomes ``(1 - m) * old + m * var_biased`` = ``new - (new - (1 - m) *
    old) / n``. Eval mode and the state-dict keys are torch's.

    With one value a channel (n = 1: a 1x1 pooled map or a vector at batch
    1) torch refuses to train; flax takes its one-pass statistics, mean =
    E[x] and var = max(E[x^2] - E[x]^2, 0) = 0, in float32, so it outputs
    the bias and moves the running variance toward 0 (``_one_value``).
    """

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        if x.numel() == x.shape[1]:
            return self._one_value(x)
        new = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, new, self.weight, self.bias, True,
                           self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.copy_(new - (new - (1.0 - self.momentum) * self.running_var) / n)
        return out

    def _one_value(self, x):
        """flax's train-mode BatchNorm of x with one value a channel, in
        float32 at least, y in x's dtype. y is computed from x, so that the
        layer before gets a gradient (of zeros) as in flax, and with it the
        weight decay the optimizer applies to the parameters it steps."""
        dims = [0] + list(range(2, x.dim()))
        view = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dims)
        var = (xf.square().mean(dims) - mean.square()).clamp(min=0.0)
        y = ((xf - mean.view(view)) * torch.rsqrt(var + self.eps).view(view)
             * self.weight.view(view) + self.bias.view(view))
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.to(self.running_var.dtype), alpha=m)
        return y.to(x.dtype)


class BatchNorm2d(_FlaxRunningVar, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance follows flax's ``BatchNorm``."""


class BatchNorm1d(_FlaxRunningVar, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` over [n, c] vectors whose running variance follows
    flax's ``BatchNorm`` (ResNeSt's split attention)."""


def same_padding(kernel: int, stride: int, dilation: int = 1, size=None) -> tuple[int, int]:
    """(before, after) padding of a TF-style "SAME" window over ``size``
    pixels: out = ceil(size / stride), the odd pixel after. ``size`` None
    means one divisible by ``stride``."""
    size = stride if size is None else size
    total = max((-(-size // stride) - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """``nn.Conv2d`` with TF-style ``"SAME"`` padding (flax ``padding="SAME"``,
    Paddle ``padding='same'``): out = ceil(in / stride), the padding split with
    the odd pixel at the bottom and right. For kernel 3 and stride 2 on an
    even map that is (0, 1), not (1, 1). Under a spatial shard
    (``parallel/spatial.py``) the rows' padding is the image's, from its
    global height: a rank reads ``halo_rows`` of its neighbours."""

    spatial = None

    def forward(self, x):
        (k_h, k_w), (s_h, s_w), (d_h, d_w) = self.kernel_size, self.stride, self.dilation
        cols = same_padding(k_w, s_w, d_w, x.shape[3])
        shard = sharded(self)
        if shard is None:
            pads = [*cols, *same_padding(k_h, s_h, d_h, x.shape[2])]
            return self._conv_forward(F.pad(x, pads), self.weight, self.bias)
        return shard.window(x, lambda t, rows: self._conv_forward(
            F.pad(t, [*cols, *rows]), self.weight, self.bias), k_h, s_h, d_h,
            same_padding(k_h, s_h, d_h, x.shape[2] * shard.world))


def halo_rows(kernel: int, stride: int, dilation: int, padding: int) -> tuple[int, int]:
    """(rows above, rows below) that a window op (a conv, a pool) over a
    block of rows divisible by ``stride`` reads beyond it: ``padding``
    above and ``(kernel - 1) * dilation - padding - (stride - 1)`` below
    (none if negative). With them in place it runs with no padding along H
    and gives the block's own output rows (``parallel/spatial.py``)."""
    return padding, max(0, (kernel - 1) * dilation - padding - (stride - 1))


def sharded(module):
    """The ``SpatialShard`` a module of a spatially sharded region runs over
    in training mode (``parallel/spatial.py::shard_model_``), else None: in
    eval mode the whole model runs on every rank."""
    return module.spatial if module.training else None


class ShardedWhole:
    """A zoo model that a spatial shard splits whole (SETR, Segmenter, DPT,
    SegFormer, UperNet, FCN: ``parallel/spatial.py``). In training mode
    under a ``SpatialShard`` (``spatial``) every module runs on the rank's
    image rows (the backbone's attentions over keys and values gathered
    from the group, the heads' convs through halos, their resizes through
    ``upsample``, their BatchNorm over the gradient group) and its outputs
    are the rank's rows; a module marked ``spatial_replicated`` (the
    UperHead's pyramid-pooling bins) runs on a map gathered whole on every
    rank. A model with prefix tokens (ViT's
    cls token, DeiT's two) holds them on spatial rank 0 alone, so that the
    other ranks' steps leave them without a gradient: DistributedDataParallel
    then has to look for unused parameters, and only then."""

    spatial = None
    prefix_tokens = True

    def spatial_region(self):
        """The modules that run on a rank's rows under a spatial shard: all."""
        return (self,)

    @property
    def ddp_find_unused_parameters(self) -> bool:
        return self.spatial is not None and self.prefix_tokens


class HaloConv2d(nn.Conv2d):
    """``nn.Conv2d`` of a spatially sharded region (``shard_model_`` swaps
    the class in place): under its shard it gives the rank's output rows,
    the rows it reads above and below the rank's coming from the
    neighbouring ranks (zeros at the image's edges; ``SpatialShard.window``)."""

    spatial = None

    def forward(self, x):
        shard = sharded(self)
        if shard is None:
            return super().forward(x)
        return shard.window(x, lambda t, rows: F.conv2d(
            t, self.weight, self.bias, self.stride, (rows[0], self.padding[1]), self.dilation,
            self.groups), self.kernel_size[0], self.stride[0], self.dilation[0],
            self.padding[0])


def max_pool_3x3s2(x, shard=None):
    """``F.max_pool2d(x, 3, stride=2, padding=1)``; over a ``shard``'s rows,
    the row above from the rank above (-inf at the image's top)."""
    if shard is None:
        return F.max_pool2d(x, 3, stride=2, padding=1)
    return shard.window(x, lambda t, rows: F.max_pool2d(t, 3, stride=2, padding=(rows[0], 1)),
                        3, 2, 1, 1, mode="-inf")


def avg_pool_3x3(x, stride: int, shard=None):
    """``F.avg_pool2d(x, 3, stride, 1)``, whose divisor counts the padding
    (9 everywhere); over a ``shard``'s rows, the row above from the rank
    above (zeros at the image's top)."""
    if shard is None:
        return F.avg_pool2d(x, 3, stride, 1)
    return shard.window(x, lambda t, rows: F.avg_pool2d(t, 3, stride, (rows[0], 1)),
                        3, stride, 1, 1)


def upsample(x, size, shard=None, align_corners: bool = False):
    """``resize_bilinear(x, size, align_corners)``; over a ``shard``'s rows,
    ``size`` the rank's and the factor along H an integer, the rank's
    output rows (``SpatialShard.upsample_rows``: one row of each neighbour,
    which a resize over the rank's rows alone would clamp to its own edge
    row). HRNet's fuse and the zoo's heads (SETR's PUP, Naive and MLA
    heads, DPT's fusion blocks and last x2, SegFormer's stage maps and x4,
    the Segmenter's masks, the UperHead's top-down and finest-level
    resizes and x4, UperNet's aux x16, Trans2Seg's and FCN's) resize
    through here. A resize to the input's
    own size is the identity, sharded or not."""
    if shard is None or tuple(int(v) for v in size) == tuple(x.shape[-2:]):
        return resize_bilinear(x, size, align_corners)
    return shard.upsample_rows(x, size, align_corners)


class RowDropout(nn.Dropout):
    """``nn.Dropout`` that draws its mask through ``split_dropout``, whole
    or, under a spatial shard, the full mask of the image's rows cut to the
    rank's along ``dim`` (2 of NCHW maps; 1 of NHWC maps and of tokens [b,
    n, c], whose rows ``lead`` tokens precede on spatial rank 0, ViT's cls
    token, and ``tail`` tokens follow on every rank, the Segmenter's class
    tokens): one process and a sharded run draw alike."""

    spatial = None
    lead = 0
    tail = 0

    def __init__(self, p: float = 0.5, dim: int = 2):
        super().__init__(p)
        self.dim = dim

    def forward(self, x):
        shard = sharded(self)
        block = None if shard is None else (
            self.dim, *shard.block(x.shape[self.dim], self.lead, self.tail), self.tail)
        return split_dropout(x, self.p, self.training, self.dim, block=block)


def conv2d(cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1,
           padding=None, groups: int = 1, bias: bool = False) -> nn.Conv2d:
    """Kaiming-initialised conv; padding None pads dilation * (kernel // 2) on
    every side, "same" is TF-style (``Conv2dSame``), an int pads that."""
    if padding == "same":
        return kaiming_normal_(Conv2dSame(cin, cout, kernel, stride, 0, dilation,
                                          groups, bias))
    pad = dilation * (kernel // 2) if padding is None else padding
    return kaiming_normal_(nn.Conv2d(cin, cout, kernel, stride, pad, dilation, groups, bias))


class ConvBNReLU(nn.Sequential):
    """conv(k, no bias) + BatchNorm(eps 1e-5) + ReLU, as ``[0]``, ``[1]``, ``[2]``
    (the reference's Sequential indices). padding: as ``conv2d``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1, padding=None):
        super().__init__(
            conv2d(in_channels, out_channels, kernel_size, stride, dilation, padding),
            BatchNorm2d(out_channels, eps=1e-5),
            nn.ReLU(inplace=True))


class AdaptiveAvgPool(nn.Module):
    """``ops/pooling.py::adaptive_avg_pool`` as a module (the pyramid-pooling
    branches' first entry)."""

    def __init__(self, output_size: int):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return adaptive_avg_pool(x, self.output_size)


class Mlp(nn.Module):
    """Transformer FFN: ``fc1`` -> GELU (tanh form, flax's ``nn.gelu``) ->
    dropout -> ``fc2`` -> dropout, over tokens [b, n, c] or NHWC maps (its
    dropout a ``RowDropout`` along dim 1)."""

    def __init__(self, dim: int, hidden: int, dropout: float = 0.0):
        super().__init__()
        self.fc1 = xavier_uniform_(nn.Linear(dim, hidden))
        self.fc2 = xavier_uniform_(nn.Linear(hidden, dim))
        self.dropout = RowDropout(dropout, 1)

    def forward(self, x):
        x = self.dropout(F.gelu(self.fc1(x), approximate="tanh"))
        return self.dropout(self.fc2(x))


class DropPath(nn.Module):
    """Stochastic depth: in training, zero each sample's branch with
    probability ``rate`` and scale the kept ones by 1 / (1 - rate)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = x.new_empty((x.shape[0],) + (1,) * (x.dim() - 1)).bernoulli_(keep)
        return x / keep * mask


NORM_EPS = 1e-6   # flax LayerNorm / GroupNorm; Paddle's is 1e-5 (ROADMAP.md queue 3, Q1)


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=NORM_EPS)


def split_dropout(x, p: float, training: bool, dim: int, shard=None, block=None):
    """Dropout at a site whose activations a model group splits along
    ``dim`` (the FFN's hidden width, the attention's heads) or a spatial
    group along image rows: the keep mask of the full width is drawn, as
    one process draws it, and a rank of a split model (``shard``,
    ``parallel/tensor.py``) keeps its slice; ``block`` (dim, first, total,
    tail): a spatial rank's entries ``[first, first + x.shape[dim] - tail)``
    of the ``total`` and the last ``tail``, which every rank holds
    (``parallel/spatial.py``, ``SpatialShard.block``). One process
    draws through here too, so a split run consumes the generator alike.
    Kept values are multiplied by 1 / (1 - p) in one kernel each way
    (``native_dropout_backward``, torch's own dropout's: flax's ``Dropout``
    divides by 1 - p, the same to a float spacing)."""
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    dim = dim % x.dim()
    full = list(x.shape)
    full[dim] *= shard.world if shard is not None else 1
    if block is not None:
        rows, first, full[rows], tail = block
    mask = torch.empty(full, dtype=torch.bool, device=x.device).bernoulli_(keep)
    if shard is not None:
        mask = mask.narrow(dim, shard.rank * x.shape[dim], x.shape[dim])
    if block is not None:
        own = mask.narrow(rows, first, x.shape[rows] - tail)
        mask = torch.cat([own, mask.narrow(rows, full[rows] - tail, tail)], rows) if tail else own
    return torch.ops.aten.native_dropout_backward(x, mask, 1.0 / keep)


class MultiHeadAttention(nn.Module):
    """Standard MHA over token sequences (reference layers.py:144-311).

    Fused ``in_proj_weight [3E, E]`` (q, k, v row blocks) and
    ``in_proj_bias [3E]`` as in the reference; scaled dot product with the
    softmax in float32, then ``out_proj``. Plain matmuls, as the JAX einsum.
    Split over a model group (``parallel/tensor.py``), a rank holds its
    heads' rows of each q, k, v block and of their biases and the matching
    input columns of ``out_proj``, whose bias is added once after the
    group's sum.
    """

    TP_SPLITS = {"in_proj_weight": (0, 3), "in_proj_bias": (0, 3), "out_proj.weight": (1, 1)}
    tp = None

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

    def tp_dims(self) -> dict:
        return {"heads": self.num_heads}

    def forward(self, query, key=None, value=None):
        key = query if key is None else key
        value = key if value is None else value
        tp = self.tp
        if tp is not None:   # one copy into the split region per distinct input
            copies = {}
            for t in (query, key, value):
                if id(t) not in copies:
                    copies[id(t)] = tp.copy_in(t)
            query, key, value = (copies[id(t)] for t in (query, key, value))
        bs, len_q, e = query.shape
        head_dim = e // self.num_heads
        heads = self.num_heads // (tp.world if tp is not None else 1)
        w_q, w_k, w_v = self.in_proj_weight.chunk(3)
        b_q, b_k, b_v = self.in_proj_bias.chunk(3)
        q = F.linear(query, w_q, b_q).view(bs, len_q, heads, head_dim)
        k = F.linear(key, w_k, b_k).view(bs, -1, heads, head_dim)
        v = F.linear(value, w_v, b_v).view(bs, -1, heads, head_dim)
        attn = torch.einsum("bqhd,bkhd->bhqk", q * head_dim ** -0.5, k)
        attn = split_dropout(attn.float().softmax(-1).to(v.dtype), self.dropout.p,
                             self.training, 1, tp)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(bs, len_q, heads * head_dim)
        if tp is None:
            return self.out_proj(out)
        return tp.reduce_out(F.linear(out, self.out_proj.weight), self.out_proj.bias)
