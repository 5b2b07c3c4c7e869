"""The port's model zoo against the JAX package's, family by family.

FCN, SETR (MLA, PUP, Naive), UperNet (Swin, CSwin, Focal at two window /
focal-level settings), DPT (each readout) and Trans2Seg at small widths
and depths, float32. Each JAX model's parameter shapes go through
``synth_pdparams`` (a reference-layout ``.pdparams`` dict of seeded random
tensors) and the JAX ``convert_pdparams`` into flax parameters, which
``state_dict_from_flax`` carries into the port, as
``test_torch_emrt_variants.py`` does for EMRT. Bounds:
- eval-mode logits of every output (main and each aux), in the JAX order:
  ``MODEL_RTOL`` x max|logit|;
- the MixSoftmax loss in train mode (BatchNorm on batch statistics, dropout
  off in both packages, drop path 0): rtol 1e-5;
- the gradients of all parameters of the eval-mode loss (BatchNorm on its
  running statistics): relative L2 within ``GRAD_RTOL`` (the conv bias the
  JAX package folds into FCN's BatchNorm mean has no counterpart and is
  left out). In train mode the backward through BatchNorm over maps of
  2 x 4 x 4 values amplifies float32 rounding: FCN's layer-3 gradients
  differ by ~2% there while the eval-mode ones agree to ~3e-7;
The families are shared with ``test_torch_zoo_uper.py`` (UperNet, with the
backbone taps), ``test_torch_zoo_dpt.py`` (DPT, Trans2Seg),
``test_torch_zoo_segformer.py`` and ``test_torch_zoo_segmenter.py`` (ViT
and DeiT, each with the mask and the linear decoder); this file runs FCN
and SETR.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from emrt_tpu.config import get_config as jax_get_config  # noqa: E402
from emrt_tpu.losses import get_loss_function as jax_loss  # noqa: E402
from emrt_tpu.utils.pdparams import convert_pdparams  # noqa: E402
from test_pdparams_zoo import _flat, synth_pdparams  # noqa: E402
from test_torch_emrt import MODEL_RTOL, load_checked  # noqa: E402

from emrt_tpu_torch.config import get_config  # noqa: E402
from emrt_tpu_torch.losses import get_loss_function  # noqa: E402
from emrt_tpu_torch.utils.pdparams import state_dict_from_flax  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
NUM_CLASSES = 6
GRAD_RTOL = 1e-3
# the JAX reference with 64-bit types enabled (its host-built constants, such
# as the resize matrices, then promote the arithmetic around them to
# float64): Trans2Seg's float32 JAX gradients differ from its float64 ones by
# ~3.4e-3 (relative L2, backbone ~4e-3, heads ~1e-5), while the port's
# float32 ones differ from the port's float64 by ~3e-6 and those from JAX's
# float64 by ~2e-6
X64 = ("trans2seg",)
LOSS_YAML = ROOT / "configs" / "setr" / "SETR_PUP_Large_256x256_160k_potsdam_bs_8.yaml"

_VIT = dict(patch_size=16, hidden_size=32, num_layers=4, num_heads=2,
            out_indices=(0, 1, 2, 3))
_FOCAL_A = dict(window_size=5, expand_sizes=(2, 2, 1, 1), focal_levels=(2, 2, 2, 2),
                focal_windows=(5, 3, 3, 1))
_FOCAL_B = dict(window_size=7, expand_sizes=(3, 1, 1, 1), focal_levels=(3, 3, 3, 2),
                focal_windows=(3, 5, 3, 1), use_conv_embed=True)
_UPER = dict(embed_dim=16, depths=(2, 2, 1, 1), uper_channels=16, aux_channels=8,
             drop_path=0.0)


def _setr(decoder, encoder, **kw):
    return dict(encoder_type=encoder, decoder_type=decoder, mla_channels=16,
                mlahead_channels=8, **_VIT, **kw)


# family -> (MODEL.NAME, MODEL.ENCODER.TYPE, input size, JAX class, port class,
#            shared kwargs, JAX-only kwargs, port-only kwargs)
FAMILIES = {
    "fcn": ("FCN", "resnet50c", 64, "fcn.FCN", "fcn.FCN",
            dict(backbone="resnet50c", output_stride=16), {}, {}),
    "setr_mla": ("SETR_MLA", "ViT_MLA", 64, "setr.SETR", "setr.SETR",
                 _setr("VIT_MLAHead", "ViT_MLA"), {}, {"img_size": (64, 64)}),
    "setr_pup": ("SETR_PUP", "ViT", 64, "setr.SETR", "setr.SETR",
                 _setr("PUP_VisionTransformerUpHead", "ViT", pup_num_conv=4,
                       pup_num_upsample=4), {}, {"img_size": (64, 64)}),
    "setr_naive": ("SETR_Naive", "ViT", 64, "setr.SETR", "setr.SETR",
                   _setr("Naive_VisionTransformerUpHead", "ViT", pup_num_conv=2,
                         pup_num_upsample=1, pup_conv3x3=False, auxpup_num_upsample=1),
                   {}, {"img_size": (64, 64)}),
    "upernet_swin": ("UperNet_Swin", "SwinTransformer", 96, "upernet.UperNet",
                     "upernet.UperNet", dict(encoder_type="SwinTransformer",
                                             num_heads=(1, 2, 4, 8), window_size=5, **_UPER),
                     {}, {"img_size": (96, 96)}),
    "upernet_cswin": ("UperNet_CSwin", "CSwinTransformer", 64, "upernet.UperNet",
                      "upernet.UperNet", dict(encoder_type="CSwinTransformer",
                                              num_heads=(2, 4, 8, 8),
                                              split_sizes=(1, 2, 3, 2), **_UPER),
                      {}, {"img_size": (64, 64)}),
    "upernet_focal_a": ("UperNet_Focal", "FocalTransformer", 96, "upernet.UperNet",
                        "upernet.UperNet", dict(encoder_type="FocalTransformer",
                                                num_heads=(1, 2, 4, 8), **_FOCAL_A, **_UPER),
                        {}, {"img_size": (96, 96)}),
    "upernet_focal_b": ("UperNet_Focal", "FocalTransformer", 96, "upernet.UperNet",
                        "upernet.UperNet", dict(encoder_type="FocalTransformer",
                                                num_heads=(1, 2, 4, 8), **_FOCAL_B, **_UPER),
                        {}, {"img_size": (96, 96)}),
    **{f"dpt_{r}": ("DPT", "ViT", 64, "dpt.DPTSeg", "dpt.DPTSeg",
                    dict(readout=r, mlp_ratio=2.0, hidden_features=(8, 16, 32, 32),
                         features=8, **{k: v for k, v in _VIT.items() if k != "patch_size"}),
                    {}, {"img_size": (64, 64)}) for r in ("project", "add", "ignore")},
    "trans2seg": ("Trans2Seg", "resnet50c", 64, "trans2seg.Trans2Seg", "trans2seg.Trans2Seg",
                  dict(embed_dim=32, depth=2, num_heads=4, mlp_ratio=3.0, hid_dim=8,
                       output_stride=16), {}, {"img_size": (64, 64)}),
    "segformer": ("Segformer", "MixVisionTransformer", 64, "segformer.Segformer",
                  "segformer.Segformer", dict(embed_dims=(8, 16, 32, 64), depths=(1, 1, 1, 1),
                                              num_heads=(1, 2, 4, 8), head_channels=16,
                                              drop_path=0.0), {}, {}),
    **{f"segmenter_{enc.lower()}_{dec}": (
        "Segmenter", enc, 64, "segmenter.Segmenter", "segmenter.Segmenter",
        dict(decoder_type="LinearDecoder" if dec == "linear" else "MaskTransformer",
             hidden_size=32, num_layers=2, num_heads=2, seg_num_layers=2,
             distilled=enc == "DeiT"), {}, {"img_size": (64, 64)})
       for enc in ("ViT", "DeiT") for dec in ("mask", "linear")},
}


def _cls(pkg, path):
    import importlib
    module, name = path.rsplit(".", 1)
    return getattr(importlib.import_module(f"{pkg}.models.{module}"), name)


def jax_model(family):
    _, _, _, jcls, _, shared, jax_kw, _ = FAMILIES[family]
    return _cls("emrt_tpu", jcls)(num_classes=NUM_CLASSES, **shared, **jax_kw)


def torch_model(family):
    _, _, _, _, tcls, shared, _, torch_kw = FAMILIES[family]
    return _cls("emrt_tpu_torch", tcls)(num_classes=NUM_CLASSES, **shared, **torch_kw)


@functools.lru_cache(maxsize=2)
def bridged(family, hw=None):
    """(pd dict, flax variables, the port's state dict) of a family, at its
    input size or ``hw`` (Swin's and Focal's tables follow the size)."""
    name, encoder, size = FAMILIES[family][:3]
    hw = hw or size
    shapes = jax.eval_shape(jax_model(family).init, jax.random.key(0),
                            jnp.zeros((1, hw, hw, 3), jnp.float32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    stats0 = zeros.get("batch_stats", {})
    pd = synth_pdparams(zeros["params"], stats0, name, encoder, seed=0)
    live_weights(pd)
    params, stats, report = convert_pdparams(pd, zeros["params"], stats0, name, encoder)
    assert report["missing"] == [] and report["unused"] == []
    assert report["unmatched_flax"] == []
    state = state_dict_from_flax(_flat(params), _flat(stats), name, encoder)
    return pd, {"params": params, "batch_stats": stats}, state


def live_weights(pd, seed=1):
    """Norm scales (LayerNorm, BatchNorm: the 1-D ``.weight``s) to U(0.5,
    1.5), the other ``.weight``s to N(0, 2 / fan_in). With
    ``synth_pdparams``' N(0, 0.05) everywhere a signal shrinks ~20x a layer:
    the logits are the last biases' to ~1e-7 and a flipped roll, an
    unflipped ConvTranspose or a row-major Trans2Seg query move them by
    less than the bounds."""
    rng = np.random.default_rng(seed)
    for key in sorted(pd):
        a = pd[key]
        if not key.endswith(".weight"):
            continue
        if a.ndim == 1:
            pd[key] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        else:
            fan_in = a.shape[0] if a.ndim == 2 else int(np.prod(a.shape[1:]))
            pd[key] = rng.normal(scale=(2 / fan_in) ** 0.5, size=a.shape).astype(np.float32)


def images(hw, bs=2, seed=1):
    return np.random.default_rng(seed).normal(size=(bs, hw, hw, 3)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def ported(family):
    return load_checked(torch_model(family), bridged(family)[2])


def _labels(hw):
    rng = np.random.default_rng(4)
    label = rng.integers(0, NUM_CLASSES, (2, hw, hw))
    return np.where(rng.random((2, hw, hw)) < 0.1, 255, label).astype(np.int32)


@functools.lru_cache(maxsize=1)
def jax_reference(family):
    """The JAX model's eval logits, the gradients of its eval-mode loss
    (in the port's keys) and its train-mode loss, on seeded inputs."""
    name, encoder, hw = FAMILIES[family][:3]
    _, variables, _ = bridged(family)
    model, x, label = jax_model(family), jnp.asarray(images(hw)), jnp.asarray(_labels(hw))
    loss_fn = jax_loss(jax_get_config(str(LOSS_YAML)))

    def eval_loss(params):
        out = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                          train=False)
        return loss_fn(list(out), label), out

    def train_loss(params):
        out, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                             train=True, mutable=["batch_stats"])
        return loss_fn(list(out), label)

    with jax.enable_x64(family in X64), _flax_dropout_off():
        (loss, out), grads = jax.jit(jax.value_and_grad(eval_loss, has_aux=True))(
            variables["params"])
        loss_train = jax.jit(train_loss)(variables["params"])
    return {"logits": [np.asarray(o).transpose(0, 3, 1, 2) for o in out],
            "loss": float(loss), "grads": state_dict_from_flax(_flat(grads), {}, name, encoder),
            "train_loss": float(loss_train)}


class _flax_dropout_off:
    """flax Dropout as the identity: the JAX heads' fixed 0.1 dropouts
    (UperHead, the FCN aux head, DPT's head) would draw masks in train
    mode."""

    def __enter__(self):
        self.saved = fnn.Dropout.__call__
        fnn.Dropout.__call__ = lambda self, x, deterministic=None, rng=None: x

    def __exit__(self, *exc):
        fnn.Dropout.__call__ = self.saved


def cases(families):
    return [(f, c) for f in families for c in ("logits", "train_loss", "grads")]


def check_family(family, check):
    """One check of a family against ``jax_reference`` (cases grouped by
    family, so that each family's reference is computed once)."""
    hw = FAMILIES[family][2]
    ref = jax_reference(family)
    x, label = nchw(images(hw)), torch.from_numpy(_labels(hw)).long()
    model = ported(family)
    loss_fn = get_loss_function(get_config(str(LOSS_YAML)))
    if check == "logits":
        with torch.no_grad():
            got = model(x)
        assert isinstance(got, list) and len(got) == len(ref["logits"])
        for g, w in zip(got, ref["logits"]):
            assert g.dtype == torch.float32 and g.shape == w.shape == (2, NUM_CLASSES, hw, hw)
            scale = np.abs(w).max()
            assert scale > 0
            assert np.abs(g.numpy() - w).max() <= MODEL_RTOL * scale
    elif check == "train_loss":
        model.train()
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        with torch.no_grad():
            loss = loss_fn(list(model(x)), label)
        np.testing.assert_allclose(loss.item(), ref["train_loss"], rtol=1e-5)
    else:
        loss = loss_fn(list(model(x)), label)
        loss.backward()
        np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
        want, got, exp, skipped = ref["grads"], [], [], []
        for key, p in model.named_parameters():
            if key not in want:
                skipped.append(key)
                continue
            got.append((torch.zeros_like(p) if p.grad is None else p.grad).flatten().double())
            exp.append(want[key].flatten().double())
        assert skipped == (["head.conv_1.0.bias"] if family == "fcn" else [])
        got, exp = torch.cat(got), torch.cat(exp)
        assert exp.norm() > 0
        assert ((got - exp).norm() / exp.norm()).item() <= GRAD_RTOL


@pytest.mark.parametrize("family, check", cases(("fcn", "setr_mla", "setr_pup",
                                                 "setr_naive")))
def test_family_matches_jax(family, check):
    check_family(family, check)


def test_output_counts_follow_the_jax_order():
    """MLA and PUP: main + 4 aux; Naive: main + 3; UperNet: main + 1; the
    rest: main only."""
    want = {"setr_mla": 5, "setr_pup": 5, "setr_naive": 4, "upernet_swin": 2,
            "upernet_cswin": 2, "upernet_focal_a": 2, "fcn": 1, "dpt_project": 1,
            "trans2seg": 1}
    for family, n in want.items():
        hw = FAMILIES[family][2]
        with torch.no_grad():
            assert len(torch_model(family).eval()(torch.zeros(1, 3, hw, hw))) == n, family


def test_models_refuse_another_input_size():
    """The ViT's and Trans2Seg's position tables and Swin's windows are made
    for one input size, as the JAX modules' parameters are."""
    for family, hw in (("setr_pup", 48), ("trans2seg", 96), ("upernet_swin", 32)):
        with pytest.raises(ValueError):
            torch_model(family)(torch.zeros(1, 3, hw, hw))
