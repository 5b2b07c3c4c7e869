"""The port's EMRT backbone variants against the JAX package's EMRT.

For each variant of the EMRT yamls (CSwin, ViT, HRNet-W48, SegFormer-B4
MixViT), the JAX EMRT's parameter shapes go through ``synth_pdparams`` (a
reference-layout ``.pdparams`` dict of seeded random tensors) and
``convert_pdparams`` into flax parameters, which ``state_dict_from_flax``
carries into the port, as ``test_torch_emrt.py`` does for EMRT-R50. The
models have 1 encoder and 1 decoder layer and a 64^2 input; CSwin and ViT
run at small widths, HRNet and the MixViT at the widths the JAX dispatch
fixes. Bounds:
- eval-mode main and aux logits: ``MODEL_RTOL`` x max|logit|, as EMRT-R50;
- ``load_pdparams`` of the reference-layout dict: nothing missing or unused,
  and the logits of the flax route to 1e-5;
- eval-mode gradients of the MixSoftmax loss (running BatchNorm statistics,
  no dropout or drop path; drop path is random in training, so train-mode
  steps cannot be compared): relative L2 over all parameters within 1e-3.

Also here: ``get_model`` builds the model of every EMRT yaml (on the meta
device: ViT-L alone holds ~300M parameters), and the variant yamls' slide
stride, which leaves pixels no window covers in both packages (F5).
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from emrt_tpu.config import get_config as jax_get_config  # noqa: E402
from emrt_tpu.inference import slide as jax_slide  # noqa: E402
from emrt_tpu.losses import get_loss_function as jax_loss  # noqa: E402
from emrt_tpu.models.emrt import EMRT as JaxEMRT  # noqa: E402
from emrt_tpu.utils.pdparams import convert_pdparams  # noqa: E402
from test_pdparams_zoo import _flat, synth_pdparams  # noqa: E402
from test_torch_emrt import MODEL_RTOL, NUM_CLASSES, load_checked  # noqa: E402

from emrt_tpu_torch.config import get_config  # noqa: E402
from emrt_tpu_torch.inference import slide as torch_slide  # noqa: E402
from emrt_tpu_torch.losses import get_loss_function  # noqa: E402
from emrt_tpu_torch.models import get_model  # noqa: E402
from emrt_tpu_torch.models.emrt import EMRT  # noqa: E402
from emrt_tpu_torch.utils.pdparams import load_pdparams, state_dict_from_flax  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
HW = 64
GRAD_RTOL = 1e-3

_CSWIN = dict(trans_embed_dim=32, trans_depths=(1, 1, 1, 1), trans_splits=(1, 2, 7, 7))
_VIT = dict(vit_hidden=64, vit_layers=4, vit_heads=4, vit_out_indices=(0, 1, 2, 3))
# variant -> (MODEL.NAME, MODEL.ENCODER.TYPE, EMRT knobs)
VARIANTS = {
    "cswin": ("EMRT_CSwin", "CSwinTransformer", _CSWIN),
    "vit": ("EMRT_ViT", "ViT", _VIT),
    "hrnet": ("EMRT_HRNet", "HRNet", {}),
    "segformer": ("EMRT_Segformer", "segformer_b4", {}),
}
# the SegFormer wrapper's head: in the reference's state dict, read by nothing
_SEGFORMER_HEAD = {"backbone.linear_c1.proj.weight": (64, 768),
                   "backbone.linear_fuse._conv.weight": (768, 3072, 1, 1),
                   "backbone.linear_pred.weight": (6, 768, 1, 1)}


def _jax_emrt(variant):
    name, encoder, knobs = VARIANTS[variant]
    return JaxEMRT(num_classes=NUM_CLASSES, backbone=encoder, num_encoder_layers=1,
                   num_decoder_layers=1, use_pallas=False, **knobs)


def _torch_emrt(variant):
    name, encoder, knobs = VARIANTS[variant]
    backbone = {"EMRT_CSwin": "CSwinTransformer", "EMRT_ViT": "ViT",
                "EMRT_HRNet": "HRNet"}.get(name, encoder)
    return EMRT(num_classes=NUM_CLASSES, backbone=backbone, num_encoder_layers=1,
                num_decoder_layers=1, img_size=(HW, HW), **knobs)


@functools.lru_cache(maxsize=1)
def bridged(variant):
    """(pd dict, flax variables, the port's state dict) of a variant."""
    name, encoder, _ = VARIANTS[variant]
    shapes = jax.eval_shape(_jax_emrt(variant).init, jax.random.key(0),
                            jnp.zeros((1, HW, HW, 3), jnp.float32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    pd = synth_pdparams(zeros["params"], zeros["batch_stats"], name, encoder, seed=0)
    params, stats, report = convert_pdparams(pd, zeros["params"], zeros["batch_stats"],
                                             name, encoder)
    assert report["missing"] == [] and report["unused"] == []
    assert report["unmatched_flax"] == []
    state = state_dict_from_flax(_flat(params), _flat(stats), name, encoder)
    return pd, {"params": params, "batch_stats": stats}, state


def _images(bs=2, seed=1):
    return np.random.default_rng(seed).normal(size=(bs, HW, HW, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("variant, check", [(v, c) for v in VARIANTS
                                            for c in ("logits", "pdparams")])
def test_variant_matches_jax(variant, check):
    """(grouped by variant, so that ``bridged`` builds each once)"""
    if check == "logits":
        _check_logits(variant)
    else:
        _check_pdparams_load(variant)


def _check_logits(variant):
    _, variables, state = bridged(variant)
    x = _images()
    want = jax.jit(_jax_emrt(variant).apply, static_argnames="train")(
        variables, jnp.asarray(x), train=False)
    model = load_checked(_torch_emrt(variant), state)
    with torch.no_grad():
        got = model(_nchw(x))
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.dtype == torch.float32 and g.shape == w.shape == (2, NUM_CLASSES, HW, HW)
        scale = np.abs(w).max()
        assert scale > 0
        assert np.abs(g.numpy() - w).max() <= MODEL_RTOL * scale


def _check_pdparams_load(variant):
    """The reference-layout dict loaded directly gives the flax route's logits."""
    pd, _, state = bridged(variant)
    pd = dict(pd)
    if variant == "segformer":
        rng = np.random.default_rng(2)
        pd.update({k: rng.normal(size=s).astype(np.float32)
                   for k, s in _SEGFORMER_HEAD.items()})
    direct = _torch_emrt(variant)
    report = load_pdparams(direct, pd)
    assert report["missing"] == [] and report["unused"] == []
    n_dead = 1 + (len(_SEGFORMER_HEAD) if variant == "segformer" else 0)
    assert report["matched"] == len(pd) - n_dead
    bridge = load_checked(_torch_emrt(variant), state)
    x = _nchw(_images(bs=1))
    with torch.no_grad():
        for a, b in zip(direct.eval()(x), bridge(x)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item())


@pytest.mark.parametrize("variant", ["cswin", "vit"])
def test_variant_eval_gradients_match_jax(variant):
    name, encoder, _ = VARIANTS[variant]
    _, variables, state = bridged(variant)
    x = _images(seed=3)
    rng = np.random.default_rng(4)
    label = rng.integers(0, NUM_CLASSES, (2, HW, HW))
    label = np.where(rng.random((2, HW, HW)) < 0.1, 255, label).astype(np.int32)
    cfg = jax_get_config(str(ROOT / "configs" / "EMRT" / "EMRT_256x256_160k_potsdam.yaml"))
    model_j, loss_j = _jax_emrt(variant), jax_loss(cfg)

    def loss_of(params):
        out = model_j.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=False)
        return loss_j(list(out), jnp.asarray(label))

    loss_want, grads = jax.jit(jax.value_and_grad(loss_of))(variables["params"])
    want = state_dict_from_flax(_flat(grads), {}, name, encoder)

    model = load_checked(_torch_emrt(variant), state)
    pcfg = get_config(str(ROOT / "configs" / "EMRT" / "EMRT_256x256_160k_potsdam.yaml"))
    loss = get_loss_function(pcfg)(list(model(_nchw(x))), torch.from_numpy(label).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_want), rtol=1e-5)
    got, ref = [], []
    for key, p in model.named_parameters():
        # UpHead's conv biases: the JAX package folds them into BatchNorm
        # means, which take no gradient
        if key.startswith("uphead.conv_") and key.endswith(".bias"):
            continue
        g = torch.zeros_like(p) if p.grad is None else p.grad
        got.append(g.flatten().double())
        ref.append(want[key].flatten().double())
    got, ref = torch.cat(got), torch.cat(ref)
    assert ref.norm() > 0
    assert ((got - ref).norm() / ref.norm()).item() <= GRAD_RTOL


EMRT_YAMLS = sorted(p.name for p in (ROOT / "configs" / "EMRT").glob("EMRT_*.yaml"))


def test_every_emrt_yaml_is_listed():
    assert len(EMRT_YAMLS) == 22      # the smoke yaml among them


@pytest.mark.parametrize("yaml", EMRT_YAMLS)
def test_get_model_builds_every_emrt_yaml(yaml):
    cfg = get_config(str(ROOT / "configs" / "EMRT" / yaml))
    with torch.device("meta"):
        model = get_model(cfg)
    expect = {"EMRT_CSwin": "taps", "EMRT_ViT": "taps", "EMRT_HRNet": "hrnet"}.get(
        cfg.MODEL.NAME, {"segformer_b4": "mit", "hrnet": "hrnet"}.get(
            cfg.MODEL.ENCODER.TYPE, "cnn"))
    assert model.variant == expect
    assert model.uphead.conv_3.out_channels == cfg.DATA.NUM_CLASSES


def test_variant_stride_leaves_pixels_no_window_covers():
    """F5: VAL.STRIDE_SIZE 320 over a 256 crop skips bands of 64 pixels; both
    packages' window grids leave them uncovered and their stitched logits
    are 0 / 0 there."""
    h, w, crop, stride = 600, 700, (256, 256), (320, 320)
    grids = [pkg.window_grid(h, w, crop, stride) for pkg in (jax_slide, torch_slide)]
    assert grids[0] == grids[1]
    count = np.zeros((h, w), np.int64)
    for h1, w1 in grids[0]:
        count[h1:h1 + 256, w1:w1 + 256] += 1
    rows, cols = (count == 0).all(1), (count == 0).all(0)
    assert rows.sum() == cols.sum() == 64                   # [256, 320) both ways
    assert rows[256:320].all() and cols[256:320].all()
    uncovered = int((count == 0).sum())
    assert uncovered == h * w - (h - 64) * (w - 64)

    imgs = np.random.default_rng(0).normal(size=(1, h, w, 3)).astype(np.float32)
    got_j = np.asarray(jax_slide.slide_inference(
        lambda x: jnp.ones(x.shape[:3] + (2,), jnp.float32), jnp.asarray(imgs),
        crop, stride, 2))
    got_t = torch_slide.slide_inference(
        lambda x: torch.ones((x.shape[0], 2) + tuple(x.shape[2:])), _nchw(imgs),
        crop, stride, 2).numpy().transpose(0, 2, 3, 1)
    for got in (got_j, got_t):
        assert np.isnan(got).sum() == 2 * uncovered
        assert np.all(np.isnan(got[0, :, :, 0]) == (count == 0))
