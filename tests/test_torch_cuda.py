"""Tests of the port's CUDA kernels that need a card.

They skip without a CUDA device (the kernels have no CPU mode) and import no
JAX, so they run on a GPU machine that has only PyTorch:
``python3 -m pytest tests/test_torch_cuda.py -q``. Each kernel is held to its
plain PyTorch version on the same inputs (the forward to the plain core, the
backward kernel to the core's autograd): max |kernel - plain| <=
1e-5 x max|plain| + 1e-6 in float32 (the sums differ in order only; the
value gradient's atomics add in an order that changes from run to run) and
<= 1e-2 x max|plain| in bfloat16 (one rounding of the output). Out of
bounds, every output is exactly 0.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from emrt_tpu_torch.models.deformable_transformer import _offset_bias_init  # noqa: E402
from emrt_tpu_torch.models.position_encoding import encoder_reference_points  # noqa: E402
from emrt_tpu_torch.ops import deformable_cuda  # noqa: E402
from emrt_tpu_torch.ops.deformable import (DeformableAttentionFunction,  # noqa: E402
                                           deformable_attention,
                                           deformable_attention_core)

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

LEVELS = ((32, 32), (16, 16), (8, 8))


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, dtype, loc_set, bs=2, len_q=1344, heads=8, points=6, levels=LEVELS,
            channels=32):
    gen = torch.Generator(device=device).manual_seed(0)
    n_lv = len(levels)
    len_v = sum(h * w for h, w in levels)
    value = torch.randn((bs, len_v, heads, channels), generator=gen, device=device).to(dtype)
    attn = torch.randn((bs, len_q, heads, n_lv * points), generator=gen, device=device)
    attn = attn.softmax(-1).view(bs, len_q, heads, n_lv, points).to(dtype)
    shape = (bs, len_q, heads, n_lv, points, 2)
    if loc_set == "random":
        loc = torch.rand(shape, generator=gen, device=device) * 1.2 - 0.1
    elif loc_set == "out of bounds":
        loc = torch.rand(shape, generator=gen, device=device) * 0.4 + 1.6
    else:
        ref = encoder_reference_points(levels, device=device)[:len_q]
        off = torch.from_numpy(_offset_bias_init(heads, n_lv, points)).to(device)
        norm = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32,
                            device=device)
        loc = (ref[:, None, :, None, :] + off.view(heads, n_lv, points, 2)
               / norm[None, :, None, :]).expand(shape).contiguous()
    return value, loc, attn


@pytest.mark.parametrize("loc_set", ["random", "out of bounds", "on the grid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("len_q", [1344, 110])
def test_kernel_matches_plain_version(device, dtype, loc_set, len_q):
    value, loc, attn = _inputs(device, dtype, loc_set, len_q=len_q)
    before = deformable_cuda.launches
    got = deformable_attention(value, LEVELS, loc, attn)
    want = deformable_attention_core(value, LEVELS, loc, attn)
    torch.cuda.synchronize()
    assert deformable_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape == (2, len_q, 256)
    if loc_set == "out of bounds":
        assert not got.any()
        return
    scale = want.float().abs().max().item()
    tol = 1e-5 * scale + 1e-6 if dtype == torch.float32 else 1e-2 * scale
    assert (got.float() - want.float()).abs().max().item() <= tol


def _tol(want, dtype):
    scale = want.float().abs().max().item()
    return 1e-5 * scale + 1e-6 if dtype == torch.float32 else 1e-2 * scale


def plain_grads(value, loc, attn, grad_out, levels=LEVELS):
    """The plain core's autograd: (grad value, grad loc, grad attn)."""
    v, l, a = (t.detach().clone().requires_grad_() for t in (value, loc, attn))
    out = deformable_attention_core(v, levels, l, a)
    return torch.autograd.grad(out, (v, l, a), grad_out)


@pytest.mark.parametrize("loc_set", ["random", "out of bounds", "on the grid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("len_q", [1344, 110])
def test_backward_kernels_match_plain_autograd(device, dtype, loc_set, len_q):
    value, loc, attn = _inputs(device, dtype, loc_set, len_q=len_q)
    gen = torch.Generator(device=device).manual_seed(1)
    grad_out = torch.randn((2, len_q, 256), generator=gen, device=device).to(dtype)
    before = deformable_cuda.bwd_launches
    got = deformable_cuda.ms_deform_attn_bwd(value, LEVELS, loc, attn, grad_out)
    want = plain_grads(value, loc, attn, grad_out)
    torch.cuda.synchronize()
    assert deformable_cuda.bwd_launches == before + 1
    for g, w, t in zip(got, want, (value, loc, attn)):
        assert g.dtype == w.dtype == t.dtype and g.shape == w.shape == t.shape
        if loc_set == "out of bounds":
            assert not g.any() and not w.any()
        else:
            assert (g.float() - w.float()).abs().max().item() <= _tol(w, dtype)


# the EMRT variants' levels at a 256^2 input: ViT's three stride-16 taps,
# HRNet's and ResNet OS8's three 32^2 maps, ResNet OS16's 32^2/16^2/16^2
VARIANT_LEVELS = {"16^2x3": ((16, 16),) * 3, "32^2x3": ((32, 32),) * 3,
                  "32-16-16": ((32, 32), (16, 16), (16, 16))}


@pytest.mark.parametrize("loc_set", ["random", "out of bounds", "on the grid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("query", ["encoder", "decoder"])
@pytest.mark.parametrize("levels", list(VARIANT_LEVELS.values()), ids=list(VARIANT_LEVELS))
def test_kernels_at_the_variants_level_shapes(device, levels, query, dtype, loc_set):
    """The forward and backward kernels where levels repeat a size: the
    encoder's queries are its tokens (Lq = Lv), the decoder's the 110 pooled
    ones."""
    len_q = sum(h * w for h, w in levels) if query == "encoder" else 110
    value, loc, attn = _inputs(device, dtype, loc_set, len_q=len_q, levels=levels)
    grad_out = torch.randn((2, len_q, 256), device=device).to(dtype)
    got = [deformable_cuda.ms_deform_attn_fwd(value, levels, loc, attn),
           *deformable_cuda.ms_deform_attn_bwd(value, levels, loc, attn, grad_out)]
    want = [deformable_attention_core(value, levels, loc, attn),
            *plain_grads(value, loc, attn, grad_out, levels)]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if loc_set == "out of bounds":
            assert not g.any() and not w.any()
        else:
            assert (g.float() - w.float()).abs().max().item() <= _tol(w, dtype)


# where the backward's plan keeps gV: every level in shared memory, the one
# level in global memory, or both; each with one block per (b, h) (write: 110
# queries) and with a (b, h) split over blocks (accumulate: 1,024 queries,
# the plan's split of 16 (b, h) over the SMs)
ROUTES = {"shared": LEVELS, "global": ((64, 64),), "mixed": ((64, 64), (32, 32), (16, 16))}


@pytest.mark.parametrize("loc_set", ["random", "on the grid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["write", "accumulate"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_backward_routes_of_the_value_gradient(device, route, mode, dtype, loc_set):
    levels = ROUTES[route]
    len_q = 110 if mode == "write" else 1024
    plan = deformable_cuda.bwd_plan(
        levels, 32, 2, 8, len_q, torch.cuda.get_device_properties(device).multi_processor_count,
        splits=1 if mode == "write" else None)
    offsets = plan.smem_offsets
    assert plan.accumulate == (mode == "accumulate")
    assert {"shared": min(offsets) >= 0, "global": max(offsets) < 0,
            "mixed": min(offsets) < 0 <= max(offsets)}[route]
    value, loc, attn = _inputs(device, dtype, loc_set, len_q=len_q, levels=levels)
    grad_out = torch.randn((2, len_q, 256), device=device).to(dtype)
    got = deformable_cuda.ms_deform_attn_bwd(value, levels, loc, attn, grad_out, plan=plan)
    want = plain_grads(value, loc, attn, grad_out, levels)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() <= _tol(w, dtype)


@pytest.mark.parametrize("mode", ["write", "accumulate"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_head_dim_64(device, dtype, mode):
    """Two chunks of 32 channels per head: the backward's loop over chunks
    (every EMRT yaml has head dim 32, so nothing else runs it)."""
    len_q = 110 if mode == "write" else 1024
    plan = deformable_cuda.bwd_plan(LEVELS, 64, 2, 4, len_q,
                                    splits=1 if mode == "write" else 4)
    value, loc, attn = _inputs(device, dtype, "random", len_q=len_q, heads=4, channels=64)
    grad_out = torch.randn((2, len_q, 256), device=device).to(dtype)
    got = [deformable_cuda.ms_deform_attn_fwd(value, LEVELS, loc, attn),
           *deformable_cuda.ms_deform_attn_bwd(value, LEVELS, loc, attn, grad_out, plan=plan)]
    want = [deformable_attention_core(value, LEVELS, loc, attn),
            *plain_grads(value, loc, attn, grad_out)]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() <= _tol(w, dtype)


def test_function_gradients_match_plain_version(device):
    """Small f32 problem through autograd: the Function's output and three
    gradients against the plain core's."""
    value, loc, attn = _inputs(device, torch.float32, "random", bs=1, len_q=50)
    grad_out = torch.randn((1, 50, 256), device=device)
    ins = [t.clone().requires_grad_() for t in (value, loc, attn)]
    out = deformable_attention(ins[0], LEVELS, ins[1], ins[2])
    assert out.grad_fn is not None and "DeformableAttentionFunction" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, ins, grad_out)
    want = plain_grads(value, loc, attn, grad_out)
    ref = deformable_attention_core(value, LEVELS, loc, attn)
    assert (out - ref).abs().max().item() <= _tol(ref, torch.float32)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= _tol(w, torch.float32)


def test_kernel_refuses_mixed_devices(device):
    value, loc, attn = _inputs(device, torch.float32, "random", len_q=110)
    with pytest.raises(ValueError, match="one CUDA device"):
        deformable_cuda.ms_deform_attn_fwd(value, LEVELS, loc.cpu(), attn)
    grad_out = torch.zeros((2, 110, 256), device=device)
    with pytest.raises(ValueError, match="one CUDA device"):
        deformable_cuda.ms_deform_attn_bwd(value, LEVELS, loc, attn, grad_out.cpu())
