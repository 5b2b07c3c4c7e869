"""Plain PyTorch operations of the reference EMRT: the precision its
matmuls and convolutions run in, dropout drawn as the measured program
draws it, bilinear resize, adaptive pooling, the sine position tables and
the multi-scale deformable-attention core.

Nothing here imports the measured package. Float32 throughout; in
``Precision("fp8")`` (the control, one step below the bfloat16 the
configurations state) both operands of every matmul and convolution are
rounded through float8 e4m3 with a per-tensor scale, as an fp8 path would
run them, and everything else stays float32.
"""
from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0   # largest finite float8 e4m3fn


class _RoundFP8(torch.autograd.Function):
    """x rounded through float8 e4m3 at the scale that maps its largest
    magnitude to ``FP8_MAX``; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().float().clamp(min=1e-12)
        scale = FP8_MAX / amax
        return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _RoundBF16(torch.autograd.Function):
    """x rounded to bfloat16, and its gradient too."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(torch.bfloat16).to(grad.dtype)


class Precision:
    """``"f32"``: float32 with TF32 off. ``"fp8"``: the control.
    ``"bf16"``: operands, biases and outputs of the matmuls and
    convolutions rounded to bfloat16 both ways, as autocast runs them (a
    witness of what bfloat16 itself does to a number compared)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8", "bf16"):
            raise ValueError(f"precision {name!r}: 'f32', 'fp8' or 'bf16'")
        self.name = name

    def q(self, x):
        if x is None or self.name == "f32":
            return x
        return (_RoundFP8 if self.name == "fp8" else _RoundBF16).apply(x)

    def out(self, y):
        return _RoundBF16.apply(y) if self.name == "bf16" else y

    def conv(self, x, w, b, stride, padding, dilation, groups):
        b = self.q(b) if self.name == "bf16" else b
        return self.out(F.conv2d(self.q(x), self.q(w), b, stride, padding, dilation, groups))

    def linear(self, x, w, b=None):
        b = self.q(b) if self.name == "bf16" else b
        return self.out(F.linear(self.q(x), self.q(w), b))

    def einsum(self, eq, a, b):
        return self.out(torch.einsum(eq, self.q(a), self.q(b)))


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN inside, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def dropout(x, p: float, training: bool, draw_dtype: torch.dtype):
    """Dropout whose keep mask is the one ``F.dropout`` draws for a tensor of
    ``x``'s shape in ``draw_dtype`` (the dtype the measured program's
    activation has there: its generator use depends on it), applied to
    ``x`` in its own precision."""
    if not training or p == 0.0:
        return x
    keep = F.dropout(torch.ones(x.shape, dtype=draw_dtype, device=x.device), p, True) != 0
    return x * keep / (1.0 - p)


def mask_dropout(x, p: float, training: bool):
    """Dropout whose keep mask is a boolean tensor of ``x``'s shape drawn by
    ``bernoulli_`` (the measured program's whole-map and attention
    dropouts), whatever ``x``'s dtype."""
    if not training or p == 0.0:
        return x
    keep = torch.empty(x.shape, dtype=torch.bool, device=x.device).bernoulli_(1.0 - p)
    return x * keep / (1.0 - p)


def resize(x, size, align_corners: bool = False):
    """Bilinear resize of NCHW ``x`` to ``size``; the identity at its own size."""
    size = (int(size[0]), int(size[1]))
    if size == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)


def adaptive_avg_pool(x, size: int):
    return F.adaptive_avg_pool2d(x.float(), size).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sine_table(h: int, w: int, num_pos_feats: int) -> np.ndarray:
    """DETR's normalised sine table (temperature 1e4, offset -0.5, scale
    2 pi), y first, sin and cos interleaved: [h, w, 2 * num_pos_feats]."""
    y = np.tile(np.arange(1, h + 1, dtype=np.float64)[:, None], (1, w))
    x = np.tile(np.arange(1, w + 1, dtype=np.float64)[None, :], (h, 1))
    y = (y - 0.5) / (h + 1e-6) * 2 * math.pi
    x = (x - 0.5) / (w + 1e-6) * 2 * math.pi
    dim_t = 10000.0 ** (2 * (np.arange(num_pos_feats) // 2).astype(np.float64) / num_pos_feats)
    px, py = x[:, :, None] / dim_t, y[:, :, None] / dim_t
    px = np.stack([np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])], axis=3).reshape(h, w, -1)
    py = np.stack([np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])], axis=3).reshape(h, w, -1)
    return np.concatenate([py, px], axis=2).astype(np.float32)


def level_tables(spatial_shapes, hidden_dim: int, device):
    """(sine position embedding [sum(HW), C], encoder reference points
    [sum(HW), L, 2], offset normaliser (W, H) [L, 2]) of the levels."""
    pos = torch.cat([torch.from_numpy(_sine_table(h, w, hidden_dim // 2).reshape(h * w, -1))
                     for h, w in spatial_shapes])
    refs = []
    for h, w in spatial_shapes:
        ry, rx = np.meshgrid(np.linspace(0.5, h - 0.5, h) / h,
                             np.linspace(0.5, w - 0.5, w) / w, indexing="ij")
        refs.append(np.stack([rx.reshape(-1), ry.reshape(-1)], axis=-1))
    ref = np.tile(np.concatenate(refs)[:, None, :], (1, len(spatial_shapes), 1))
    norm = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32)
    return (pos.to(device), torch.from_numpy(ref.astype(np.float32)).to(device),
            norm.to(device))


def deformable_core(value, spatial_shapes, loc, attn):
    """Multi-scale deformable attention by gathers, in float32: per level a
    bilinear sample at ``x = loc_x * W - 0.5``, ``y = loc_y * H - 0.5`` from
    its four corners (zero outside the map), weighted by ``attn`` and summed
    over levels and points.

    value [bs, Lv, nh, c]; loc [bs, Lq, nh, L, P, 2]; attn [bs, Lq, nh, L, P]
    -> [bs, Lq, nh * c].
    """
    bs, _, nh, c = value.shape
    _, len_q, _, _, n_points, _ = loc.shape
    v_all = value.float().permute(0, 2, 1, 3)
    loc_all = loc.float().permute(0, 2, 3, 1, 4, 5)
    attn_all = attn.float().permute(0, 2, 3, 1, 4)
    out = torch.zeros((bs, nh, len_q, c), dtype=torch.float32, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = v_all[:, :, start:start + h * w]
        start += h * w
        x = loc_all[:, :, lvl, ..., 0] * w - 0.5
        y = loc_all[:, :, lvl, ..., 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        x0, y0 = x0.long(), y0.long()
        a = attn_all[:, :, lvl]
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                xi, yi = x0 + dx, y0 + dy
                valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
                g = torch.gather(v, 2, idx.reshape(bs, nh, -1, 1).expand(-1, -1, -1, c))
                out += ((wx * wy * a * valid.float()).unsqueeze(-1)
                        * g.view(bs, nh, len_q, n_points, c)).sum(3)
    return out.permute(0, 2, 1, 3).reshape(bs, len_q, nh * c)
