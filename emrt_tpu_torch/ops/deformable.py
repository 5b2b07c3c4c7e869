"""Multi-scale deformable attention core: the plain PyTorch version and the
dispatcher in front of the CUDA kernel.

Counterpart of ``emrt_tpu/ops/deformable.py::deformable_attention_core`` with
the same layouts and numerics: per level, a bilinear sample of the value map
at ``x = loc_x * W - 0.5``, ``y = loc_y * H - 0.5`` (``grid_sample`` with
``align_corners=False`` and zero padding), taken as four floor-based corners
with their own validity masks, weighted by the attention weights and summed
over levels and points in float32.

``deformable_attention_core`` is the plain version: the CPU path and the
reference the kernels are held to, forward and backward (its autograd).
``deformable_attention`` is what the model calls: CPU tensors take the plain
version, CUDA tensors take the kernels (``ops/deformable_cuda.py``) or the
call raises: the forward kernel K1 alone without grad, and
``DeformableAttentionFunction`` (K1 forward, the fused K2 and K3 backward)
with it.
"""
from __future__ import annotations

import torch


def deformable_attention_core(value, spatial_shapes, sampling_locations,
                              attention_weights):
    """
    Args:
      value: [bs, Len_v, n_head, c] multi-level values, flattened level-major.
      spatial_shapes: static tuple ((H0, W0), (H1, W1), ...); sum(H*W) == Len_v.
      sampling_locations: [bs, Len_q, n_head, n_levels, n_points, 2] in [0, 1]
        (x, y) normalized coordinates (including padding area).
      attention_weights: [bs, Len_q, n_head, n_levels, n_points], softmaxed
        over levels*points.

    Returns:
      [bs, Len_q, n_head * c] in value's dtype, accumulated in float32.
    """
    bs, _, n_head, c = value.shape
    _, len_q, _, n_levels, n_points, _ = sampling_locations.shape
    if n_levels != len(spatial_shapes):
        raise ValueError(f"{n_levels} sampling levels but {len(spatial_shapes)} "
                         f"spatial shapes")

    # heads ahead of tokens so each (b, h) gathers from its own [hw, c] map
    v_all = value.float().permute(0, 2, 1, 3)                       # [bs, nh, Lv, c]
    loc_all = sampling_locations.float().permute(0, 2, 3, 1, 4, 5)  # [bs, nh, L, Lq, P, 2]
    attn_all = attention_weights.float().permute(0, 2, 3, 1, 4)     # [bs, nh, L, Lq, P]
    out = torch.zeros((bs, n_head, len_q, c), dtype=torch.float32,
                      device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        value_l = v_all[:, :, start:start + h * w]
        start += h * w
        x = loc_all[:, :, lvl, ..., 0] * w - 0.5                    # [bs, nh, Lq, P]
        y = loc_all[:, :, lvl, ..., 1] * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        x0i = x0.long()
        y0i = y0.long()
        attn = attn_all[:, :, lvl]
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                xi = x0i + dx
                yi = y0i + dy
                valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
                cw = wx * wy * attn * valid.float()
                g = torch.gather(value_l, 2, idx.reshape(bs, n_head, -1, 1)
                                 .expand(-1, -1, -1, c))
                # elementwise, not einsum: no autocast or TF32 reaches the sum
                out += (cw.unsqueeze(-1)
                        * g.view(bs, n_head, len_q, n_points, c)).sum(3)
    return out.permute(0, 2, 1, 3).reshape(bs, len_q, n_head * c).to(value.dtype)


class DeformableAttentionFunction(torch.autograd.Function):
    """K1 forward, fused K2 and K3 backward: the counterpart of the JAX package's
    ``custom_vjp`` around ``deformable_attention_pallas``.

    apply(value, spatial_shapes, sampling_locations, attention_weights) ->
    [bs, Lq, nh*c]; the gradients come in the inputs' dtypes (value's and
    the attention weights', f32 for the locations). The kernels take
    contiguous inputs on one CUDA device and raise on anything else.
    """

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations, attention_weights):
        from .deformable_cuda import ms_deform_attn_fwd
        ctx.spatial_shapes = tuple(spatial_shapes)
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return ms_deform_attn_fwd(value, spatial_shapes, sampling_locations,
                                  attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        from .deformable_cuda import ms_deform_attn_bwd
        value, loc, attn = ctx.saved_tensors
        grad_value, grad_loc, grad_attn = ms_deform_attn_bwd(
            value, ctx.spatial_shapes, loc, attn, grad_out.contiguous())
        need = ctx.needs_input_grad
        return (grad_value if need[0] else None, None,
                grad_loc if need[2] else None, grad_attn if need[3] else None)


def deformable_attention(value, spatial_shapes, sampling_locations,
                         attention_weights):
    """Same contract as ``deformable_attention_core``.

    CPU tensors go to the plain version (and its autograd). Any other tensor
    goes to the CUDA kernels, whose wrappers raise on what they do not take:
    through ``DeformableAttentionFunction`` when grad is on and an input
    requires it, straight to the forward kernel otherwise.
    """
    if value.device.type == "cpu":
        return deformable_attention_core(value, spatial_shapes,
                                         sampling_locations, attention_weights)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, sampling_locations, attention_weights)):
        return DeformableAttentionFunction.apply(
            value, spatial_shapes, sampling_locations, attention_weights)
    from .deformable_cuda import ms_deform_attn_fwd
    return ms_deform_attn_fwd(value, spatial_shapes, sampling_locations,
                              attention_weights)
