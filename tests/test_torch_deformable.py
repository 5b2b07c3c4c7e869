"""The port's deformable-attention core against the JAX package's.

The plain PyTorch version (``emrt_tpu_torch.ops.deformable``) is held to the
jnp golden (``emrt_tpu.ops.deformable``) and to the Pallas kernel in
interpret mode, on the same numpy inputs, at rtol = atol = 1e-5 in float32
(the bound ``test_pallas_kernel.py`` uses): the two differ only in the order
of float32 sums. Location sets: random in [-0.1, 1.1], all out of bounds
(exact zeros), and on the pixel grid (encoder reference points plus the
rotated-grid init offsets). Its three gradients (autograd) are held to
``jax.vjp`` of the golden the same way, each within 1e-5 x its max; on the
grid both take the one-sided derivative of the floor. The CUDA kernels'
argument checks, the backward's launch plan and the autograd Function's
wiring run here before any launch; the kernels themselves are compared on
the card.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from emrt_tpu.ops.deformable import deformable_attention_core as jax_core  # noqa: E402
from emrt_tpu.ops.deformable_pallas import deformable_attention_pallas  # noqa: E402
from emrt_tpu_torch.models.deformable_transformer import _offset_bias_init  # noqa: E402
from emrt_tpu_torch.models.position_encoding import encoder_reference_points  # noqa: E402
import chip_smoke  # noqa: E402
from emrt_tpu_torch.ops import deformable_cuda  # noqa: E402
from emrt_tpu_torch.ops.deformable import (DeformableAttentionFunction,  # noqa: E402
                                           deformable_attention,
                                           deformable_attention_core)

torch.set_num_threads(1)

FLAGSHIP = ((32, 32), (16, 16), (8, 8))
# (bs, nh, c, P, spatial shapes, Lq): the Pallas test's small problem, then
# the flagship decoder and encoder calls at bs 1
PROBLEMS = {
    "small": (2, 4, 32, 6, ((8, 8), (4, 4)), 80),
    "decoder": (1, 8, 32, 6, FLAGSHIP, 110),
    "encoder": (1, 8, 32, 6, FLAGSHIP, 1344),
}


def make_inputs(problem: str, loc_set: str, seed: int = 0):
    bs, nh, c, npt, shapes, lq = PROBLEMS[problem]
    nl = len(shapes)
    lv = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((bs, lv, nh, c)).astype(np.float32)
    logits = rng.standard_normal((bs, lq, nh, nl * npt))
    attn = np.exp(logits - logits.max(-1, keepdims=True))
    attn = (attn / attn.sum(-1, keepdims=True)).reshape(bs, lq, nh, nl, npt)
    shape = (bs, lq, nh, nl, npt, 2)
    if loc_set == "random":
        loc = rng.uniform(-0.1, 1.1, shape)
    elif loc_set == "out of bounds":
        loc = np.where(rng.random(shape) < 0.5, rng.uniform(-1.0, -0.6, shape),
                       rng.uniform(1.6, 2.0, shape))
    else:   # on the grid
        ref = encoder_reference_points(shapes).numpy()[:lq]          # [Lq, L, 2]
        off = _offset_bias_init(nh, nl, npt).reshape(nh, nl, npt, 2)
        norm = np.asarray([[w, h] for h, w in shapes], np.float32)
        loc = np.broadcast_to(ref[:, None, :, None, :]
                              + off / norm[None, :, None, :], shape)
    return shapes, value, loc.astype(np.float32), attn.astype(np.float32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("loc_set", ["random", "out of bounds", "on the grid"])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_plain_core_matches_jnp_golden(problem, loc_set):
    shapes, value, loc, attn = make_inputs(problem, loc_set)
    want = np.asarray(jax_core(jnp.asarray(value), shapes, jnp.asarray(loc),
                               jnp.asarray(attn)))
    got = deformable_attention_core(*_torch(value), shapes, *_torch(loc, attn))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if loc_set == "out of bounds":
        assert not got.any()
    else:
        assert np.abs(want).max() > 0.1


def test_plain_core_matches_pallas_interpret():
    shapes, value, loc, attn = make_inputs("small", "random")
    want = np.asarray(deformable_attention_pallas(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn), True))
    got = deformable_attention_core(*_torch(value), shapes, *_torch(loc, attn))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _grad_out(value, loc, seed=7):
    bs, lq = loc.shape[:2]
    return np.random.default_rng(seed).standard_normal(
        (bs, lq, value.shape[2] * value.shape[3])).astype(np.float32)


def _plain_grads(shapes, value, loc, attn, g):
    ins = [t.clone().requires_grad_() for t in _torch(value, loc, attn)]
    out = deformable_attention_core(ins[0], shapes, ins[1], ins[2])
    return [x.numpy() for x in torch.autograd.grad(out, ins, torch.from_numpy(g))]


@pytest.mark.parametrize("loc_set", ["random", "out of bounds", "on the grid"])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_plain_core_gradients_match_jax_vjp(problem, loc_set):
    """grad value, grad loc, grad attn of the plain version's autograd
    against jax.vjp of the jnp golden, each within 1e-5 x its max."""
    shapes, value, loc, attn = make_inputs(problem, loc_set)
    g = _grad_out(value, loc)
    _, vjp = jax.vjp(lambda v, l, a: jax_core(v, shapes, l, a),
                     jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    got = _plain_grads(shapes, value, loc, attn, g)
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == y.dtype == np.float32
        if loc_set == "out of bounds":
            assert not x.any() and not y.any()
        else:
            scale = np.abs(y).max()
            assert scale > 0
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5 * scale)


def test_plain_core_gradients_match_pallas_interpret():
    """Off the grid only: at integer coordinates the Pallas backward takes
    sign(0) = 0 (fault F1 of ROADMAP.md queue 3), the plain version the
    one-sided derivative. Bound as in test_pallas_kernel.py: the Pallas
    backward sums through dense one-hot products."""
    shapes, value, loc, attn = make_inputs("small", "random")
    g = _grad_out(value, loc)
    _, vjp = jax.vjp(lambda v, l, a: deformable_attention_pallas(v, shapes, l, a, True),
                     jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    for x, y in zip(_plain_grads(shapes, value, loc, attn, g), want):
        scale = np.abs(y).max()
        np.testing.assert_allclose(x / scale, y / scale, rtol=2e-4, atol=2e-5)


def test_plain_core_bf16_accumulates_in_f32():
    """bf16 values in, f32 sums, one rounding to bf16 at the end."""
    shapes, value, loc, attn = make_inputs("small", "random")
    v16 = torch.from_numpy(value).bfloat16()
    got = deformable_attention_core(v16, shapes, *_torch(loc, attn))
    want = deformable_attention_core(v16.float(), shapes, *_torch(loc, attn))
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


def test_dispatcher_takes_plain_version_for_cpu_tensors():
    shapes, value, loc, attn = make_inputs("small", "on the grid")
    args = _torch(value, loc, attn)
    got = deformable_attention(args[0], shapes, args[1], args[2])
    want = deformable_attention_core(args[0], shapes, args[1], args[2])
    assert torch.equal(got, want)


def _meta(shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("which", [0, 1, 2])
def test_dispatcher_sends_grad_off_cpu_to_the_function(which, monkeypatch):
    """A non-CPU input that requires grad goes through the autograd Function:
    K1 forward, then K2/K3 for the backward. Meta tensors stand for CUDA
    ones; the kernel wrappers are replaced by recorders."""
    calls = []

    def fwd(value, shapes, loc, attn):
        calls.append("fwd")
        return torch.empty((1, 7, 128), device="meta")

    def bwd(value, shapes, loc, attn, grad_out):
        calls.append("bwd")
        return torch.zeros_like(value), torch.zeros_like(loc), torch.zeros_like(attn)

    monkeypatch.setattr(deformable_cuda, "ms_deform_attn_fwd", fwd)
    monkeypatch.setattr(deformable_cuda, "ms_deform_attn_bwd", bwd)
    args = [_meta((1, 80, 4, 32)), _meta((1, 7, 4, 2, 3, 2)), _meta((1, 7, 4, 2, 3))]
    args[which].requires_grad_()
    out = deformable_attention(args[0], ((8, 8), (4, 4)), args[1], args[2])
    assert type(out.grad_fn).__name__ == "DeformableAttentionFunctionBackward"
    (grad,) = torch.autograd.grad(out, args[which], torch.ones_like(out))
    assert calls == ["fwd", "bwd"] and grad.shape == args[which].shape
    with torch.no_grad():        # grad off: the forward kernel alone
        out = deformable_attention(args[0], ((8, 8), (4, 4)), args[1], args[2])
    assert out.grad_fn is None and calls == ["fwd", "bwd", "fwd"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_backward_returns_the_kernel_gradients(dtype, monkeypatch):
    """The Function's wiring on CPU tensors, with the kernel wrappers replaced
    by the plain version and its autograd: output, gradient order and dtypes
    as the plain version's."""
    def fwd(value, shapes, loc, attn):
        return deformable_attention_core(value, shapes, loc, attn)

    def bwd(value, shapes, loc, attn, grad_out):
        ins = [t.detach().requires_grad_() for t in (value, loc, attn)]
        with torch.enable_grad():       # a backward runs with grad off
            out = deformable_attention_core(ins[0], shapes, *ins[1:])
        return torch.autograd.grad(out, ins, grad_out)

    monkeypatch.setattr(deformable_cuda, "ms_deform_attn_fwd", fwd)
    monkeypatch.setattr(deformable_cuda, "ms_deform_attn_bwd", bwd)
    shapes, value, loc, attn = make_inputs("small", "random")
    v, l, a = _torch(value, loc, attn)
    v, a = v.to(dtype), a.to(dtype)
    ins = [t.clone().requires_grad_() for t in (v, l, a)]
    out = DeformableAttentionFunction.apply(ins[0], shapes, ins[1], ins[2])
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(out.shape)).to(dtype)
    got = torch.autograd.grad(out, ins, g)
    ref_ins = [t.clone().requires_grad_() for t in (v, l, a)]
    ref = deformable_attention_core(ref_ins[0], shapes, ref_ins[1], ref_ins[2])
    want = torch.autograd.grad(ref, ref_ins, g)
    assert torch.equal(out, ref)
    for x, y, t in zip(got, want, (v, l, a)):
        assert x.dtype == t.dtype and torch.equal(x, y)


def test_dispatcher_sends_non_cpu_tensors_to_the_kernel():
    args = [_meta((1, 80, 4, 32)), _meta((1, 7, 4, 2, 3, 2)), _meta((1, 7, 4, 2, 3))]
    with pytest.raises(ValueError, match="one CUDA device"):
        deformable_attention(args[0], ((8, 8), (4, 4)), args[1], args[2])


def _kernel_args(**change):
    """A valid CPU call of the kernel wrapper, with one argument altered."""
    shapes, value, loc, attn = make_inputs("small", "random")
    args = dict(value=torch.from_numpy(value), spatial_shapes=shapes,
                sampling_locations=torch.from_numpy(loc),
                attention_weights=torch.from_numpy(attn))
    for k, fn in change.items():
        args[k] = fn(args[k])
    return args


@pytest.mark.parametrize("change, error, match", [
    (dict(value=lambda v: v.half()), TypeError, "float32 or bfloat16"),
    (dict(sampling_locations=lambda l: l.double()), TypeError, "must be float32"),
    (dict(attention_weights=lambda a: a.bfloat16()), TypeError, "attention_weights"),
    (dict(value=lambda v: v.transpose(1, 2).contiguous().transpose(1, 2)),
     ValueError, "value must be contiguous"),
    (dict(sampling_locations=lambda l: l.transpose(0, 1).contiguous().transpose(0, 1)),
     ValueError, "sampling_locations must be contiguous"),
    (dict(sampling_locations=lambda l: l[:, ::2]), ValueError, "attention_weights"),
    (dict(value=lambda v: v[..., :16].contiguous()), ValueError, "multiple of 32"),
    (dict(spatial_shapes=lambda s: ((8, 8), (2, 2))), ValueError, "do not sum"),
    (dict(), ValueError, "one CUDA device"),
])
def test_kernel_wrapper_refuses_before_launch(change, error, match):
    with pytest.raises(error, match=match):
        deformable_cuda.ms_deform_attn_fwd(**_kernel_args(**change))


@pytest.mark.parametrize("change, error, match", [
    (lambda g: g[:, :5].contiguous(), ValueError, "grad_out must be"),
    (lambda g: g.bfloat16(), TypeError, "the output's dtype"),
    (lambda g: g.transpose(0, 1).contiguous().transpose(0, 1), ValueError,
     "grad_out must be contiguous"),
    (lambda g: g, ValueError, "one CUDA device"),
])
def test_backward_wrapper_refuses_before_launch(change, error, match):
    args = _kernel_args()
    grad_out = torch.zeros((2, 80, 128))
    before = deformable_cuda.bwd_launches
    with pytest.raises(error, match=match):
        deformable_cuda.ms_deform_attn_bwd(*args.values(), change(grad_out))
    assert deformable_cuda.bwd_launches == before


@pytest.mark.parametrize("name", ["value", "grad_out", "sampling_locations"])
def test_backward_wrapper_refuses_misaligned_tensors(name):
    """The backward reads value and grad_out 16 bytes and a location 8 bytes
    at a time: a contiguous view that starts 4 bytes off is refused before
    launch."""
    args = dict(_kernel_args(), grad_out=torch.zeros((2, 80, 128)))
    t = args[name]
    args[name] = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    assert args[name].is_contiguous()
    before = deformable_cuda.bwd_launches
    with pytest.raises(ValueError, match=f"{name} must start at a multiple"):
        deformable_cuda.ms_deform_attn_bwd(**args)
    assert deformable_cuda.bwd_launches == before


def test_backward_wrapper_refuses_a_plan_of_other_levels():
    plan = deformable_cuda.bwd_plan(((8, 8),), 32, 2, 4, 80)
    with pytest.raises(ValueError, match="the plan has 1 levels"):
        deformable_cuda.ms_deform_attn_bwd(*_kernel_args().values(), torch.zeros((2, 80, 128)),
                                           plan=plan)


def test_kernel_wrapper_refuses_more_than_four_levels():
    shapes = ((4, 4),) * 5
    value = torch.zeros((1, 80, 4, 32))
    loc = torch.zeros((1, 3, 4, 5, 2, 2))
    attn = torch.zeros((1, 3, 4, 5, 2))
    with pytest.raises(ValueError, match="1 to 4 levels"):
        deformable_cuda.ms_deform_attn_fwd(value, shapes, loc, attn)
    assert deformable_cuda.launches == 0


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(deformable_cuda, "_fns", {})
    monkeypatch.setattr(deformable_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(deformable_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(deformable_cuda.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        deformable_cuda.build()


@pytest.mark.parametrize("batch", [32, 8, 2])
@pytest.mark.parametrize("shape", chip_smoke.SHAPES, ids=[s[0] for s in chip_smoke.SHAPES])
def test_bwd_plan_fits_shared_memory(shape, batch, heads=8):
    """At every call shape the smoke run drives: the levels' f32 gV tiles in
    shared memory sit side by side within 227 KB, smallest levels first (the
    same for f32 and bf16 values: the tiles are f32 for both), and the
    query tiles cover Lq, split only while (b, h) are fewer than the SMs."""
    _, levels, len_q = shape[:3]
    plan = deformable_cuda.bwd_plan(levels, 32, batch, heads, len_q)
    assert plan.smem_bytes <= 227 * 1024 == deformable_cuda.SMEM_PER_BLOCK
    spans = sorted((off * 4, off * 4 + h * w * 32 * 4)
                   for off, (h, w) in zip(plan.smem_offsets, levels) if off >= 0)
    assert spans and spans[0][0] == 0 and spans[-1][1] == plan.smem_bytes
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    left_out = [h * w for off, (h, w) in zip(plan.smem_offsets, levels) if off < 0]
    kept = [h * w for off, (h, w) in zip(plan.smem_offsets, levels) if off >= 0]
    assert not left_out or min(left_out) >= max(kept)
    assert plan.splits * plan.q_tile >= len_q > (plan.splits - 1) * plan.q_tile
    assert plan.splits == 1 or batch * heads * plan.splits <= deformable_cuda.H100_SMS


def test_bwd_plan_sends_the_64x64_level_to_global_memory():
    """At 512^2 the 64^2 level's tile (512 KB) does not fit; 32^2 and 16^2 do."""
    plan = deformable_cuda.bwd_plan(((64, 64), (32, 32), (16, 16)), 32, 32, 8, 5376)
    assert plan.smem_offsets[0] == -1 and min(plan.smem_offsets[1:]) >= 0
    assert plan.smem_bytes == (32 * 32 + 16 * 16) * 32 * 4
    assert plan.needs_buffer and not plan.accumulate


def test_bwd_plan_keeps_every_flagship_level_in_shared_memory():
    """32^2, 16^2 and 8^2 take 168 KB. At bs 32 one block owns each (b, h)
    and writes gV once (no f32 buffer); at bs 8 two blocks share one."""
    plan = deformable_cuda.bwd_plan(FLAGSHIP, 32, 32, 8, 1344)
    assert min(plan.smem_offsets) >= 0 and plan.smem_bytes == 172_032
    assert (plan.splits, plan.q_tile, plan.needs_buffer) == (1, 1344, False)
    plan = deformable_cuda.bwd_plan(FLAGSHIP, 32, 8, 8, 1344)
    assert (plan.splits, plan.q_tile, plan.accumulate) == (2, 672, True)
    assert plan.ints() == (672, 1, 172_032, 10240, 2048, 0)


def test_bwd_plan_takes_a_given_split():
    """A given split overrides the plan's choice (the smoke run times both)."""
    plan = deformable_cuda.bwd_plan(FLAGSHIP, 32, 8, 8, 1344, splits=1)
    assert (plan.splits, plan.q_tile, plan.accumulate, plan.needs_buffer) == (1, 1344, False,
                                                                              False)
    plan = deformable_cuda.bwd_plan(FLAGSHIP, 32, 32, 8, 110, splits=2)
    assert (plan.splits, plan.q_tile, plan.accumulate) == (2, 55, True)


@pytest.mark.parametrize("batch, len_q, splits", [(32, 1344, 1), (16, 1344, 1), (8, 1344, 2),
                                                  (8, 110, 1), (2, 1344, 6), (2, 5376, 8)])
def test_bwd_plan_splits_a_head_only_to_fill_the_sms(batch, len_q, splits):
    """Fewer (b, h) than the 132 SMs: as many blocks per (b, h) as fill
    them, but none with fewer than 256 queries."""
    plan = deformable_cuda.bwd_plan(FLAGSHIP, 32, batch, 8, len_q)
    assert plan.splits == splits and plan.accumulate == (splits > 1)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [32, 8, 2])
@pytest.mark.parametrize("shape", chip_smoke.SHAPES, ids=[s[0] for s in chip_smoke.SHAPES])
def test_fwd_plan_fits_shared_memory(shape, batch, dtype, heads=8):
    """At every call shape the smoke run drives: K1's staged value slabs sit
    side by side within 227 KB, smallest levels first; blocks_per_sm of them
    fit an SM's 228 KB; the query tiles cover Lq, split only while that fills
    more of the card's blocks, or in 2 where a level is read from global
    memory; a plan that stages nothing has tiles of under 128 queries that,
    staged, would not fit the card in one wave."""
    _, levels, len_q = shape[:3]
    plan = deformable_cuda.fwd_plan(levels, 32, dtype, batch, heads, len_q)
    staged = deformable_cuda.fwd_plan(levels, 32, dtype, batch, heads, len_q, stage=True)
    assert staged.q_tile == plan.q_tile
    if not plan.staged:
        assert plan.smem_offsets == (-1,) * len(levels) and plan.smem_bytes == 0
        assert plan.blocks_per_sm == 2 and plan.q_tile < deformable_cuda.FWD_MIN_STAGE_QUERIES
        slots = deformable_cuda.H100_SMS * staged.blocks_per_sm
        assert batch * heads * plan.splits > slots
        plan = staged
    size = dtype.itemsize
    assert plan.smem_bytes <= deformable_cuda.SMEM_PER_BLOCK
    spans = sorted((off, off + h * w * 32 * size)
                   for off, (h, w) in zip(plan.smem_offsets, levels) if off >= 0)
    assert spans and spans[0][0] == 0 and spans[-1][1] == plan.smem_bytes
    assert all(a[1] == b[0] and a[0] % 16 == 0 for a, b in zip(spans, spans[1:]))
    left_out = [h * w for off, (h, w) in zip(plan.smem_offsets, levels) if off < 0]
    kept = [h * w for off, (h, w) in zip(plan.smem_offsets, levels) if off >= 0]
    assert not left_out or min(left_out) >= max(kept)
    assert 1 <= plan.blocks_per_sm <= 2
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= deformable_cuda.SMEM_PER_SM
    two_fit = 2 * (plan.smem_bytes + 1024) <= deformable_cuda.SMEM_PER_SM
    assert (plan.blocks_per_sm == 2) == two_fit
    assert plan.splits * plan.q_tile >= len_q > (plan.splits - 1) * plan.q_tile
    slots = deformable_cuda.H100_SMS * plan.blocks_per_sm
    global_level = min(plan.smem_offsets) < 0
    assert plan.splits == 1 or batch * heads * plan.splits <= slots or (
        global_level and plan.splits == 2)
    assert plan.splits >= 2 or not global_level
    assert plan.ints() == (plan.q_tile, plan.smem_bytes, *plan.smem_offsets)


@pytest.mark.parametrize("dtype, smem, per_sm", [(torch.float32, 172_032, 1),
                                                 (torch.bfloat16, 86_016, 2)])
def test_fwd_plan_stages_every_flagship_level(dtype, smem, per_sm):
    """32^2, 16^2 and 8^2: an 86 KB slab in bf16 (two blocks an SM), 172 KB
    in f32 (one); at bs 32 one block per (b, h)."""
    plan = deformable_cuda.fwd_plan(FLAGSHIP, 32, dtype, 32, 8, 1344)
    assert plan.staged == 3 and plan.smem_bytes == smem and plan.blocks_per_sm == per_sm
    assert plan.smem_offsets == tuple(o * dtype.itemsize // 2 for o in (20480, 4096, 0))
    assert (plan.splits, plan.q_tile) == (1, 1344)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_fwd_plan_sends_the_64x64_level_to_global_memory(dtype):
    """At 512^2 the 64^2 level's slab (256 KB in bf16) does not fit; 32^2 and
    16^2 do."""
    plan = deformable_cuda.fwd_plan(((64, 64), (32, 32), (16, 16)), 32, dtype, 32, 8, 5376)
    assert plan.smem_offsets[0] == -1 and min(plan.smem_offsets[1:]) >= 0
    assert plan.smem_bytes == (32 * 32 + 16 * 16) * 32 * dtype.itemsize


@pytest.mark.parametrize("dtype, batch, len_q, splits", [
    (torch.bfloat16, 32, 1344, 1), (torch.bfloat16, 16, 1344, 2),
    (torch.bfloat16, 8, 1344, 4), (torch.float32, 8, 1344, 2),
    (torch.bfloat16, 8, 110, 2), (torch.bfloat16, 2, 1344, 16),
    (torch.float32, 2, 110, 2), (torch.bfloat16, 1, 5376, 33)])
def test_fwd_plan_splits_a_head_to_fill_the_card(dtype, batch, len_q, splits):
    """As many blocks per (b, h) as the card's blocks (132 SMs x blocks_per_sm)
    hold beside the other (b, h), and at most ceil(Lq / 64): the decoder's
    110 queries at bs 8 go to 2 blocks of 55."""
    plan = deformable_cuda.fwd_plan(FLAGSHIP, 32, dtype, batch, 8, len_q)
    assert plan.splits == splits


@pytest.mark.parametrize("levels, dtype, batch, global_level, splits", [
    (((64, 64), (32, 32), (16, 16)), torch.bfloat16, 32, True, 2),
    (((64, 64), (32, 32), (16, 16)), torch.float32, 32, True, 2),
    (((32, 32),) * 3, torch.float32, 32, True, 2),
    (((32, 32),) * 3, torch.bfloat16, 32, False, 1),
    (((64, 64), (32, 32), (16, 16)), torch.bfloat16, 8, True, 4)])
def test_fwd_plan_splits_a_head_with_a_level_in_global_memory(levels, dtype, batch,
                                                              global_level, splits):
    """Where a level does not fit shared memory (64^2; three 32^2 levels in
    f32) a (b, h) takes 2 blocks at least, even where its one block would
    fill the card; three 32^2 levels in bf16 all fit and keep one block."""
    plan = deformable_cuda.fwd_plan(levels, 32, dtype, batch, 8, 3072)
    assert (min(plan.smem_offsets) < 0) == global_level
    assert plan.splits == splits


def test_fwd_plan_takes_a_given_split_tile_or_staging():
    plan = deformable_cuda.fwd_plan(FLAGSHIP, 32, torch.bfloat16, 8, 8, 1344, splits=1)
    assert (plan.splits, plan.q_tile, plan.staged) == (1, 1344, 3)
    plan = deformable_cuda.fwd_plan(FLAGSHIP, 32, torch.bfloat16, 32, 8, 110, q_tile=32)
    assert (plan.splits, plan.q_tile) == (4, 32)
    plan = deformable_cuda.fwd_plan(FLAGSHIP, 32, torch.float32, 32, 8, 1344, stage=False)
    assert (plan.staged, plan.smem_bytes, plan.smem_offsets) == (0, 0, (-1, -1, -1))
    assert plan.blocks_per_sm == 2
    plan = deformable_cuda.fwd_plan(FLAGSHIP, 32, torch.bfloat16, 32, 8, 110, stage=True)
    assert (plan.staged, plan.smem_bytes, plan.blocks_per_sm) == (3, 86_016, 2)


@pytest.mark.parametrize("levels, dtype, batch, len_q, staged", [
    (FLAGSHIP, torch.bfloat16, 32, 1344, 3), (FLAGSHIP, torch.float32, 32, 1344, 3),
    (FLAGSHIP, torch.bfloat16, 8, 1344, 3), (FLAGSHIP, torch.bfloat16, 2, 1344, 3),
    (FLAGSHIP, torch.bfloat16, 32, 110, 3), (FLAGSHIP, torch.float32, 32, 110, 0),
    (FLAGSHIP, torch.float32, 8, 110, 3), (((32, 32),) * 3, torch.bfloat16, 32, 110, 0),
    (((32, 32),) * 3, torch.bfloat16, 8, 110, 3)])
def test_fwd_plan_stages_long_blocks_and_short_ones_in_one_wave(levels, dtype, batch, len_q,
                                                                staged):
    """Blocks of 128 queries or more stage the slab; shorter ones (the
    decoder's 110, 55 a block at bs 8) only where, staged, all 256 or 128 of
    them fit the card at once: not where the slab leaves one block an SM
    (f32, or bf16 at three 32^2 levels) and the (b, h) are 256."""
    plan = deformable_cuda.fwd_plan(levels, 32, dtype, batch, 8, len_q)
    assert plan.staged == staged


L224, L384, L448 = chip_smoke.LEVELS_224, chip_smoke.LEVELS_384, chip_smoke.LEVELS_448


@pytest.mark.parametrize("levels, dtype, batch, len_q, want", [
    # one 193,536-byte slab a block: one block an SM, one block a (b, h)
    (L384, torch.bfloat16, 32, 3024, dict(staged=3, smem_bytes=193_536, blocks_per_sm=1,
                                          splits=1, q_tile=3024)),
    # the 384^2 decoder in bf16 and every f32 decoder at bs 32 stage nothing
    (L384, torch.bfloat16, 32, 110, dict(staged=0, splits=1)),
    (L224, torch.float32, 32, 110, dict(staged=0, splits=1)),
    (L384, torch.float32, 32, 110, dict(staged=0, splits=2)),
    (L448, torch.float32, 32, 110, dict(staged=0, splits=2)),
    # the largest level read from global memory, a (b, h) split in 2
    (L448, torch.bfloat16, 32, 4116, dict(staged=2, splits=2, q_tile=2058)),
    (L448, torch.float32, 32, 4116, dict(staged=2, splits=2, q_tile=2058)),
    (L384, torch.float32, 32, 3024, dict(staged=2, splits=2, q_tile=1512)),
    # the 7x7 level, Lq 1,029: odd tiles
    (L224, torch.bfloat16, 32, 1029, dict(staged=3, splits=1, q_tile=1029)),
    (L224, torch.bfloat16, 8, 1029, dict(staged=3, splits=4, q_tile=258))])
def test_fwd_plan_at_the_yamls_levels(levels, dtype, batch, len_q, want):
    """K1's routes at the 224^2, 384^2 and 448^2 yamls' levels (28/14/7,
    48/24/12, 56/28/14): a staged level set leaves out only the largest."""
    plan = deformable_cuda.fwd_plan(levels, 32, dtype, batch, 8, len_q)
    assert {k: getattr(plan, k) for k in want} == want
    if 0 < plan.staged < 3:
        assert plan.smem_offsets[0] == -1 and min(plan.smem_offsets[1:]) >= 0


@pytest.mark.parametrize("levels, len_q", [(L384, 3024), (L448, 4116), (L384, 110),
                                           (L448, 110)])
def test_bwd_plan_adds_the_largest_yaml_level_with_global_atomics(levels, len_q):
    """At 384^2 and 448^2 the largest level's f32 gV tile (288 KB, 392 KB)
    does not fit: it goes to the f32 buffer by global atomics, the other two
    stay in shared memory; at 224^2 all three fit (129 KB)."""
    plan = deformable_cuda.bwd_plan(levels, 32, 32, 8, len_q)
    assert plan.smem_offsets[0] == -1 and min(plan.smem_offsets[1:]) >= 0
    assert plan.needs_buffer and plan.splits == 1
    assert min(deformable_cuda.bwd_plan(L224, 32, 32, 8, 1029).smem_offsets) >= 0


@pytest.mark.parametrize("name", ["value", "sampling_locations"])
def test_kernel_wrapper_refuses_misaligned_tensors(name):
    """K1 reads value 16 bytes and a location 8 bytes at a time: a contiguous
    view that starts 4 bytes off is refused before launch."""
    args = _kernel_args()
    t = args[name]
    args[name] = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    assert args[name].is_contiguous()
    before = deformable_cuda.launches
    with pytest.raises(ValueError, match=f"{name} must start at a multiple"):
        deformable_cuda.ms_deform_attn_fwd(**args)
    assert deformable_cuda.launches == before


def test_kernel_wrapper_refuses_a_plan_of_other_levels():
    plan = deformable_cuda.fwd_plan(((8, 8),), 32, torch.float32, 2, 4, 80)
    before = deformable_cuda.launches
    with pytest.raises(ValueError, match="the plan has 1 levels"):
        deformable_cuda.ms_deform_attn_fwd(**_kernel_args(), plan=plan)
    assert deformable_cuda.launches == before


def test_kernel_wrapper_refuses_a_level_past_32_bit_offsets():
    """K1 offsets a token within a level in 32 bits: a 4096^2 level of 8
    heads x 32 channels (2^32 elements) is refused before launch (meta
    tensors: no memory)."""
    shapes = ((4096, 4096),)
    value = torch.empty((1, 4096 * 4096, 8, 32), device="meta")
    loc = torch.empty((1, 3, 8, 1, 2, 2), device="meta")
    attn = torch.empty((1, 3, 8, 1, 2), device="meta")
    with pytest.raises(ValueError, match="below 2\\^31"):
        deformable_cuda.ms_deform_attn_fwd(value, shapes, loc, attn)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [32, 8])
@pytest.mark.parametrize("shape", chip_smoke.TP_SHAPES, ids=[s[0] for s in chip_smoke.TP_SHAPES])
def test_plans_fit_at_a_tp_ranks_head_counts(shape, batch, dtype):
    """The invariants of both plans at the 4 and 2 heads a rank of a model
    group of 2 or 4 runs the flagship's calls at (``chip_smoke.TP_SHAPES``)."""
    heads = shape[3]
    test_fwd_plan_fits_shared_memory(shape, batch, dtype, heads)
    test_bwd_plan_fits_shared_memory(shape, batch, heads)


# (heads, batch, Lq) -> (K1's splits in f32, in bf16; the backward's splits)
TP_SPLITS = {(4, 32, 1344): (1, 2, 1), (2, 32, 1344): (2, 4, 2),
             (4, 8, 1344): (4, 8, 4), (2, 8, 1344): (8, 16, 6),
             (4, 32, 110): (1, 2, 1), (2, 32, 110): (2, 2, 1),
             (4, 8, 110): (2, 2, 1), (2, 8, 110): (2, 2, 1)}


@pytest.mark.parametrize("heads, batch, len_q", list(TP_SPLITS))
def test_plans_split_a_tp_ranks_fewer_heads_over_more_blocks(heads, batch, len_q):
    """Fewer (b, h) a call, more blocks a (b, h): K1 fills the card's block
    slots (two an SM in bf16, one in f32) up to ceil(Lq / 64) blocks, the
    backward the 132 SMs up to ceil(Lq / 256), adding gV through the f32
    buffer once it splits."""
    f32, bf16, bwd = TP_SPLITS[heads, batch, len_q]
    assert deformable_cuda.fwd_plan(FLAGSHIP, 32, torch.float32, batch, heads,
                                    len_q).splits == f32
    assert deformable_cuda.fwd_plan(FLAGSHIP, 32, torch.bfloat16, batch, heads,
                                    len_q).splits == bf16
    plan = deformable_cuda.bwd_plan(FLAGSHIP, 32, batch, heads, len_q)
    assert plan.splits == bwd and plan.accumulate == (bwd > 1)
