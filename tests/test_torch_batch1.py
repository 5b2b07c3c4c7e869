"""Training at one image a process: the port's BatchNorm with one value a
channel (a 1x1 pooled map or a [1, c] vector at batch 1) against flax's
``nn.BatchNorm``, the tiny EMRT train step at batch 1 against the JAX
step, and the train CLI on a yaml that asks for batch 1.

torch's train-mode BatchNorm refuses one value a channel; flax takes its
one-pass statistics, mean = E[x], var = max(E[x^2] - E[x]^2, 0) = 0, so it
outputs the bias, moves the running mean toward x and the running variance
toward 0, and passes the layer before it a gradient of exactly 0 (which the
optimizer's weight decay then acts on). Bounds:
- the layer against flax: float32 outputs, running statistics and the
  weight's and bias's gradients within 1e-6 x their largest value, x's
  within 1e-5 x the terms that cancel in it, w |dy| / sigma a channel (n =
  1: the bias exactly, and gradients of x and weight exactly 0, tensors
  and not None; at n = 2 against flax's two-pass variance, as torch takes
  it); under bf16 autocast the output within one bf16 spacing of
  flax's float32 output (exactly the rounded bias at n = 1), the gradients
  within 1e-2 x max (x's: 1e-1 x its terms);
- the tiny EMRT-R50 step at batch 1 (``test_torch_train_step.py``'s model,
  weights, solver and bounds, on its first image): loss within 1e-5
  relative, every update and running statistic within that file's bounds;
  the pool-scale-1 branch's conv and BatchNorm scale get a gradient of
  zeros, so their update is the weight decay alone (four float32 spacings
  and more), within two spacings of the JAX step's, and its running
  variance becomes exactly 0.9 x the old one in both;
- the kernels' launch plans at bs 1 (``chip_smoke.BS1_SHAPES``): their
  invariants and the splits the card ran;
- ``python -m emrt_tpu_torch.train`` on
  ``upernet_cswin_small_patch4_512x512_160k_ade20k.yaml``, which sets
  ``DATA.BATCH_SIZE: 1``, narrowed to run on the CPU: exit 0, a finite loss.
``batch1_case`` holds one train-mode forward and backward of any model at
batch 1 against its JAX module; ``test_torch_batch1_zoo.py`` and
``test_torch_batch1_variants.py`` run it over the zoo's families and the
EMRT variants.
"""
from __future__ import annotations

import contextlib
import copy
import math
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import flax.linen.normalization as normalization  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from emrt_tpu.config import get_config as jax_get_config  # noqa: E402
from emrt_tpu.losses import get_loss_function as jax_loss  # noqa: E402
from emrt_tpu.solver import get_optimizer as jax_optimizer  # noqa: E402
from emrt_tpu.solver import get_scheduler as jax_scheduler  # noqa: E402
from emrt_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from emrt_tpu.train.state import TrainState  # noqa: E402
import chip_smoke  # noqa: E402
import test_torch_deformable  # noqa: E402
from test_pdparams_zoo import _flat  # noqa: E402
from test_torch_emrt import (bridged_state_dict, bridged_weights,  # noqa: E402
                             load_checked, tiny_jax_emrt, tiny_torch_emrt)
from test_torch_slice import ROOT, _clean_env  # noqa: E402
from test_torch_train import FLAGSHIP  # noqa: E402
from test_torch_train_step import _batch  # noqa: E402

from emrt_tpu_torch.config import get_config  # noqa: E402
from emrt_tpu_torch.losses import get_loss_function  # noqa: E402
from emrt_tpu_torch.models.layers import BatchNorm1d, BatchNorm2d, DropPath  # noqa: E402
from emrt_tpu_torch.ops import deformable_cuda  # noqa: E402
from emrt_tpu_torch.solver import get_optimizer, get_scheduler  # noqa: E402
from emrt_tpu_torch.train import make_train_step  # noqa: E402
from emrt_tpu_torch.utils.pdparams import state_dict_from_flax  # noqa: E402

torch.set_num_threads(1)
C = 8
MOMENTUM = 0.1                 # flax's 0.9
F32_RTOL, BF16_RTOL = 1e-6, 1e-2
LOSS_RTOL, STATS_TOL, GRAD_RTOL, CONTROL_FACTOR = 1e-5, 1e-4, 1e-3, 5.0
SCALE1 = "psp_module.pool_branches.0"          # the EMRT's pool-scale-1 branch


# ------------------------------------------------------------ the layer alone

def _layer_inputs(shape):
    rng = np.random.default_rng(sum(shape))
    c = shape[1]
    return {"x": rng.normal(1.0, 2.0, shape).astype(np.float32),
            "dy": rng.normal(size=shape).astype(np.float32),
            "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.normal(size=c).astype(np.float32),
            "mean": rng.normal(size=c).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}


def _channels_last(a):
    return np.moveaxis(a, 1, -1) if a.ndim > 2 else a


def _flax_layer(inp, bf16):
    """flax's train-mode BatchNorm (momentum 0.9, eps 1e-5, float32, as the
    JAX package's ``ConvBNReLU``) on the NHWC (or [n, c]) input: y, the new
    running mean and variance, and the gradients of sum(y * dy) with respect
    to x, scale and bias, in the port's layout. With two values a channel
    and more it takes the variance in two passes, as torch does: the JAX
    package's one pass, E[x^2] - E[x]^2, cancels in float32 where two values
    lie close (1.3e-4 x max apart here), a rounding the port does not copy."""
    n = inp["x"].size // inp["x"].shape[1]
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.float32, use_fast_variance=n == 1)
    x = jnp.asarray(_channels_last(inp["x"]))
    if bf16:
        x = x.astype(jnp.bfloat16)
    dy = jnp.asarray(_channels_last(inp["dy"]))
    stats = {"mean": jnp.asarray(inp["mean"]), "var": jnp.asarray(inp["var"])}

    def f(x, scale, bias):
        y, new = bn.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": stats}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * dy), (y, new["batch_stats"])

    (_, (y, new)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        x, jnp.asarray(inp["scale"]), jnp.asarray(inp["bias"]))
    back = lambda a: np.moveaxis(np.asarray(a, np.float32), -1, 1) if a.ndim > 2 \
        else np.asarray(a, np.float32)  # noqa: E731
    return {"y": back(y), "mean": np.asarray(new["mean"]), "var": np.asarray(new["var"]),
            "x": back(grads[0]), "weight": np.asarray(grads[1]), "bias": np.asarray(grads[2])}


def _port_layer(inp, bf16):
    shape = inp["x"].shape
    bn = (BatchNorm2d if len(shape) == 4 else BatchNorm1d)(shape[1], eps=1e-5).train()
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                          ("running_var", "var")):
            getattr(bn, name).copy_(torch.from_numpy(inp[key]))
    x = torch.from_numpy(inp["x"])
    x = (x.bfloat16() if bf16 else x).requires_grad_()
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=bf16):
        y = bn(x)
    (y.float() * torch.from_numpy(inp["dy"])).sum().backward()
    return y, bn, x


LAYER_CASES = [((1, C, 1, 1), False), ((1, C), False), ((2, C, 1, 1), False),
               ((1, C, 1, 1), True), ((1, C), True), ((2, C, 1, 1), True)]


@pytest.mark.parametrize("shape, bf16", LAYER_CASES)
def test_one_value_a_channel_is_flaxs_batchnorm(shape, bf16):
    inp = _layer_inputs(shape)
    want = _flax_layer(inp, bf16)
    y, bn, x = _port_layer(inp, bf16)
    assert y.dtype == (torch.bfloat16 if bf16 else torch.float32) and y.shape == shape
    assert bn.num_batches_tracked.item() == 1
    one = math.prod(shape) == shape[1]
    got = {"mean": bn.running_mean, "var": bn.running_var, "x": x.grad,
           "weight": bn.weight.grad, "bias": bn.bias.grad}
    assert all(g is not None for g in got.values())
    got = {k: v.detach().float().numpy() for k, v in got.items()}
    if one:
        bias = torch.from_numpy(inp["bias"]).view((1, -1) + (1,) * (len(shape) - 2))
        if bf16:
            bias = bias.bfloat16()
        torch.testing.assert_close(y.detach(), bias.expand(shape), rtol=0, atol=0)
        assert not got["x"].any() and not got["weight"].any()
        np.testing.assert_array_equal(got["var"], np.float32(1 - MOMENTUM) * inp["var"])
    y = y.detach().float().numpy()
    # a bf16 spacing is 2^16 float32 spacings (7 fraction bits against 23)
    spacing = np.abs(np.spacing(want["y"])) * 2.0 ** 16
    out_tol = (spacing.max() if bf16 else F32_RTOL * np.abs(want["y"]).max()) + 1e-7
    assert np.abs(y - want["y"]).max() <= out_tol
    for key in ("mean", "var"):
        assert np.abs(got[key] - want[key]).max() <= F32_RTOL * np.abs(want[key]).max(), key
    rtol = BF16_RTOL if bf16 else F32_RTOL
    for key in ("weight", "bias"):
        assert np.abs(got[key] - want[key]).max() <= rtol * np.abs(want[key]).max(), key
    # x's gradient is a difference of terms of w |dy| / sigma a channel that
    # cancel (wholly at n = 1, nearly at n = 2): held to their size
    xs = _channels_last(inp["x"]).reshape(-1, shape[1])
    terms = (inp["scale"] * np.abs(_channels_last(inp["dy"]).reshape(-1, shape[1])).max(0)
             / np.sqrt(xs.var(0) + 1e-5))
    apart = np.abs(_channels_last(got["x"] - want["x"]).reshape(-1, shape[1])).max(0)
    assert (apart <= 10 * rtol * terms).all()


def test_two_values_a_channel_keep_torchs_batch_norm():
    """n >= 2 takes ``F.batch_norm`` as before: bit for bit its output."""
    inp = _layer_inputs((2, C, 1, 1))
    y, bn, _ = _port_layer(inp, False)
    want = torch.nn.functional.batch_norm(
        torch.from_numpy(inp["x"]), torch.from_numpy(inp["mean"]).clone(),
        torch.from_numpy(inp["var"]).clone(), torch.from_numpy(inp["scale"]),
        torch.from_numpy(inp["bias"]), True, MOMENTUM, 1e-5)
    torch.testing.assert_close(y.detach(), want, rtol=0, atol=0)


def test_the_layer_before_a_one_value_norm_gets_a_zero_gradient():
    """Not None: the optimizer steps (and decays) only parameters that have
    a gradient, and DDP without ``find_unused_parameters`` raises on one
    that has none."""
    conv = torch.nn.Conv2d(4, C, 1, bias=False)
    bn = BatchNorm2d(C, eps=1e-5).train()
    torch.nn.init.uniform_(bn.weight, 0.5, 1.5)
    torch.nn.init.uniform_(bn.bias, 0.5, 1.5)
    bn(conv(torch.randn(1, 4, 1, 1))).square().sum().backward()
    assert conv.weight.grad is not None and not conv.weight.grad.any()
    assert bn.weight.grad is not None and not bn.weight.grad.any()
    assert bn.bias.grad is not None and bn.bias.grad.abs().min() > 0


# ------------------------------------------------------------ any model at batch 1

def _dropout_off(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        elif isinstance(m, DropPath):
            m.rate = 0.0
    return model


class flax_dropout_off:
    """flax's Dropout and the JAX package's DropPath as the identity."""

    def __enter__(self):
        from emrt_tpu.models import layers
        self.saved = fnn.Dropout.__call__, layers.DropPath.__call__
        fnn.Dropout.__call__ = lambda self, x, *a, **k: x
        layers.DropPath.__call__ = lambda self, x, *a, **k: x

    def __exit__(self, *exc):
        from emrt_tpu.models import layers
        fnn.Dropout.__call__, layers.DropPath.__call__ = self.saved


@contextlib.contextmanager
def two_pass_variance(on=True):
    """flax's BatchNorm statistics with ``use_fast_variance`` False (the
    variance as E[(x - E[x])^2]) while ``on``."""
    saved = normalization._compute_stats
    def two_pass(*args, **kwargs):
        return saved(*args, **{**kwargs, "use_fast_variance": False})

    if on:
        normalization._compute_stats = two_pass
    try:
        yield
    finally:
        normalization._compute_stats = saved


def one_value_norms(model, x):
    """The names of ``model``'s BatchNorms that see one value a channel in a
    train-mode forward of ``x`` (run here without gradients), each with the
    name of the layer before it in its parent (the conv of a conv-BN-ReLU,
    the Linear before ResNeSt's gate norm)."""
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, inp, out, name=name: seen.append(name) if inp[0].numel() == inp[0].shape[1]
        else None)
        for name, m in model.named_modules()
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    with torch.no_grad():
        model.train()(x)
    for h in hooks:
        h.remove()
    pairs = []
    for name in dict.fromkeys(seen):
        parent, _, child = name.rpartition(".")
        siblings = list(model.get_submodule(parent)._modules)
        pairs.append((name, f"{parent}.{siblings[siblings.index(child) - 1]}"))
    return pairs


def _port_loss(model, x, label):
    """The train-mode MixSoftmax loss of ``model`` on ``x``, backward run."""
    loss = get_loss_function(get_config(str(FLAGSHIP)))(
        list(model.train()(x)), torch.from_numpy(label).long())
    loss.backward()
    return loss.item()


def _grads(source, keys):
    """The gradients of a model (zeros where a parameter has none) or a
    state dict, at ``keys``, flat in float64."""
    if isinstance(source, torch.nn.Module):
        params = dict(source.named_parameters())
        source = {k: torch.zeros_like(params[k]) if params[k].grad is None else params[k].grad
                  for k in keys}
    return torch.cat([source[k].flatten().double() for k in keys])


def batch1_case(jax_model, variables, port, x, label, name, encoder, grads=True, x64=False,
                two_pass=False):
    """One train-mode forward and backward of ``port`` (the port's model,
    its weights from ``variables`` by ``state_dict_from_flax``) at batch 1
    against ``jax_model``'s, dropout and drop path off, the MixSoftmax loss
    of the flagship config: the loss within LOSS_RTOL and every running
    statistic within STATS_TOL x its tensor's max. Where a BatchNorm sees
    one value a channel: that norm's weight and the layer before it get a
    gradient of zeros, a tensor (flax's is exactly 0 there), its bias a
    gradient; and with ``grads`` all gradients agree with the JAX ones
    within GRAD_RTOL (relative L2), or within CONTROL_FACTOR x their
    control where that is larger: how far the port's float32 gradients lie
    from its float64 ones (BatchNorm on batch statistics over few values
    amplifies float32 rounding in the backward: the narrow ResNeSt EMRT's
    read 3.6e-3 from its float64 ones, JAX's 2.0e-3, and the two 4.2e-3
    apart).
    ``x64``: the JAX reference with 64-bit types enabled
    (``test_torch_zoo.X64``); ``two_pass``: flax's BatchNorm with the
    variance in two passes, as torch takes it (the JAX package's one pass,
    E[x^2] - E[x]^2, cancels in float32; at one value a channel both give
    0). Returns the one-value norms."""
    assert x.shape[0] == 1
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    pairs = one_value_norms(_dropout_off(port), xt)
    port.load_state_dict(before)          # undo the statistics the look moved
    loss_fn = jax_loss(jax_get_config(str(FLAGSHIP)))

    def train_loss(params, image):
        out, new = jax_model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   image, train=True, mutable=["batch_stats"])
        return loss_fn(list(out), jnp.asarray(label)), new["batch_stats"]

    grads = grads and bool(pairs)
    with jax.enable_x64(x64), flax_dropout_off(), two_pass_variance(two_pass):
        if grads:
            (loss, stats), want_grads = jax.jit(jax.value_and_grad(train_loss, has_aux=True))(
                variables["params"], jnp.asarray(x))
        else:
            loss, stats = jax.jit(train_loss)(variables["params"], jnp.asarray(x))
    want_stats = {k: v for k, v in state_dict_from_flax(
        _flat(variables["params"]), _flat(stats), name, encoder).items() if "running" in k}
    got_loss = _port_loss(port, xt, label)
    np.testing.assert_allclose(got_loss, float(loss), rtol=LOSS_RTOL)
    state = port.state_dict()
    n_bn = sum(isinstance(m, torch.nn.modules.batchnorm._BatchNorm) for m in port.modules())
    assert len(want_stats) == 2 * n_bn
    for key, want in want_stats.items():
        assert (state[key].double() - want.double()).abs().max() <= \
            STATS_TOL * want.double().abs().max(), key
    params = dict(port.named_parameters())
    for bn, layer in pairs:
        for key in (f"{bn}.weight", f"{layer}.weight"):
            assert params[key].grad is not None and not params[key].grad.any(), key
        assert params[f"{bn}.bias"].grad is not None
    if grads:
        want = state_dict_from_flax(_flat(want_grads), {}, name, encoder)
        port64 = copy.deepcopy(port).double()
        port64.load_state_dict(before)
        port64.zero_grad(set_to_none=True)
        _port_loss(port64, xt.double(), label)
        g, w, g64 = (_grads(m, want) for m in (port, want, port64))
        rel = ((g - w).norm() / w.norm()).item()
        control = ((g - g64).norm() / g64.norm()).item()
        assert rel <= max(GRAD_RTOL, CONTROL_FACTOR * control), (rel, control)
    return pairs


# ------------------------------------------------------------ the tiny EMRT step

def test_tiny_emrt_train_step_at_batch_1_matches_jax(monkeypatch):
    image, label = (a[:1] for a in _batch())
    _, params, stats = bridged_weights()

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    cfg = jax_get_config(str(FLAGSHIP))
    tx = jax_optimizer(cfg, jax_scheduler(cfg), params=params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params), tx=tx)
    step = jax_make_train_step(tiny_jax_emrt(), jax_loss(cfg), donate=False)
    new_state, metrics = step(state, {"image": image, "label": label}, jax.random.key(0))
    want = state_dict_from_flax(_flat(new_state.params), _flat(new_state.batch_stats))

    before = bridged_state_dict()
    model = _dropout_off(load_checked(tiny_torch_emrt(), bridged_state_dict()))
    pcfg = get_config(str(FLAGSHIP))
    optimizer = get_optimizer(pcfg, model, get_scheduler(pcfg))
    train_step = make_train_step(model, get_loss_function(pcfg), optimizer)
    grads = {}
    for key in (f"{SCALE1}.1.weight", f"{SCALE1}.2.weight"):
        model.get_parameter(key).register_hook(
            lambda g, key=key: grads.__setitem__(key, g.clone()))
    loss = train_step({"image": torch.from_numpy(image.transpose(0, 3, 1, 2).copy()),
                       "label": torch.from_numpy(label).long()})

    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=LOSS_RTOL)
    got = model.state_dict()
    largest = max((w.double() - before[k].double()).abs().max()
                  for k, w in want.items() if "running" not in k)
    n_params = n_stats = 0
    for key, w in want.items():
        g, b, w = got[key].double(), before[key].double(), w.double()
        if "running" in key:
            n_stats += 1
            assert (g - w).abs().max() <= STATS_TOL * w.abs().max(), key
        else:
            n_params += 1
            ulp = float(np.spacing(np.float32(w.abs().max())))
            bound = 0.1 * (w - b).abs().max() + 1e-2 * largest + 2 * ulp + 1e-10
            assert (g - w).abs().max() <= bound, key
    assert n_params > 250 and n_stats > 100

    # the pool-scale-1 branch: a gradient of zeros, so the weight decay
    # alone moves it (a few float32 spacings): within two spacings of the JAX
    # step's update, which is at least four
    for key, g in grads.items():
        assert not g.any(), key
        w, b = want[key].double(), before[key].double()
        ulp = float(np.spacing(np.float32(w.abs().max())))
        assert (w - b).abs().max() >= 4 * ulp, key
        assert ((got[key].double() - w).abs().max() <= 2 * ulp), key
    var = f"{SCALE1}.2.running_var"
    old = before[var]
    np.testing.assert_array_equal(got[var].numpy(), (old * np.float32(0.9)).numpy())
    np.testing.assert_array_equal(want[var].numpy(), (old * np.float32(0.9)).numpy())


# ------------------------------------------------------------ the kernels' plans at bs 1

# (name of chip_smoke.BS1_SHAPES) -> (K1's splits in f32, in bf16; the
# backward's splits), as the H100 ran them (chip_smoke.py --batch1)
BS1_SPLITS = {"encoder 256^2 bs 1": (16, 21, 6), "decoder 256^2 bs 1": (2, 2, 1),
              "encoder 1024^2 bs 1": (16, 33, 16)}


@pytest.mark.parametrize("shape", chip_smoke.BS1_SHAPES, ids=[s[0] for s in chip_smoke.BS1_SHAPES])
def test_plans_at_batch_1(shape):
    """One image's 8 (b, h): K1 fills the card's block slots up to ceil(Lq /
    64) blocks a (b, h), the backward the 132 SMs up to ceil(Lq / 256),
    adding gV through the f32 buffer once it splits; the plans' invariants
    hold (``test_torch_deformable``'s checks)."""
    name, levels, len_q = shape
    for dtype in (torch.float32, torch.bfloat16):
        test_torch_deformable.test_fwd_plan_fits_shared_memory(shape, 1, dtype)
    test_torch_deformable.test_bwd_plan_fits_shared_memory(shape, 1)
    f32, bf16, bwd = BS1_SPLITS[name]
    assert deformable_cuda.fwd_plan(levels, 32, torch.float32, 1, 8, len_q).splits == f32
    assert deformable_cuda.fwd_plan(levels, 32, torch.bfloat16, 1, 8, len_q).splits == bf16
    plan = deformable_cuda.bwd_plan(levels, 32, 1, 8, len_q)
    assert plan.splits == bwd and plan.accumulate == (bwd > 1)


# ------------------------------------------------------------ the train CLI

UPERNET_CSWIN_S = "configs/upernet_cswin/upernet_cswin_small_patch4_512x512_160k_ade20k.yaml"


def test_train_cli_trains_the_ade20k_upernet_cswin_yaml_at_its_batch_of_1(tmp_path):
    """No DATA.BATCH_SIZE override: the yaml's own 1. Narrowed to run on the
    CPU (crop 32, embed dim 16, depths 2-2-1-1, head channels 16, eval at
    32^2)."""
    assert get_config(str(ROOT / UPERNET_CSWIN_S)).DATA.BATCH_SIZE == 1
    proc = subprocess.run(
        [sys.executable, "-m", "emrt_tpu_torch.train", "--config", UPERNET_CSWIN_S,
         "--iters", "1", "--device", "cpu",
         "DATA.DATASET", "Synthetic", "DATA.CROP_SIZE", "(32, 32)",
         "MODEL.TRANS.EMBED_DIM", "16", "MODEL.TRANS.STAGE_DEPTHS", "(2, 2, 1, 1)",
         "MODEL.UPERHEAD.CHANNELS", "16", "VAL.IMAGE_BASE_SIZE", "32",
         "VAL.CROP_SIZE", "(32, 32)", "VAL.STRIDE_SIZE", "(32, 32)",
         "SAVE_DIR", str(tmp_path)],
        cwd=ROOT, env=_clean_env(), capture_output=True, text=True, timeout=300)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-3000:]
    assert "batch: 1 a data rank" in log
    losses = [float(v) for v in re.findall(r"\[TRAIN\] iter 1/1 loss: (\S+)", log)]
    assert len(losses) == 1 and math.isfinite(losses[0]), log[-3000:]
