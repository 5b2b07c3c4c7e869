"""The port's EMRT-R50 against the JAX package's, with one set of weights.

Weights: the JAX EMRT's parameter shapes (``jax.eval_shape`` of its init) go
through ``synth_pdparams`` (a reference-layout ``.pdparams`` dict of seeded
random tensors) and ``convert_pdparams`` into flax parameters, which
``state_dict_from_flax`` carries into the port. The model is the tiny form of
``test_pdparams_zoo._tiny_emrt``: 1 encoder and 1 decoder layer, 6 classes,
64^2 input, full widths otherwise. Eval-mode main and aux logits must agree
within 2e-3 x max|logit|, the bound of the torch oracles in
``test_pdparams_oracle.py``: float32 convolution sums taken in another order
across 16 bottlenecks.
"""
from __future__ import annotations

import functools
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from emrt_tpu.models.emrt import EMRT as JaxEMRT  # noqa: E402
from emrt_tpu.utils.pdparams import convert_pdparams  # noqa: E402
from test_pdparams_zoo import _flat, synth_pdparams  # noqa: E402

from emrt_tpu_torch.config import get_config  # noqa: E402
from emrt_tpu_torch.models import get_model  # noqa: E402
from emrt_tpu_torch.models.emrt import EMRT  # noqa: E402
from emrt_tpu_torch.utils.pdparams import (load_pdparams, read_pdparams,  # noqa: E402
                                            state_dict_from_flax)

torch.set_num_threads(1)

NUM_CLASSES = 6
MODEL_RTOL = 2e-3


def tiny_jax_emrt():
    return JaxEMRT(num_classes=NUM_CLASSES, backbone="resnet50",
                   num_encoder_layers=1, num_decoder_layers=1, use_pallas=False)


@functools.lru_cache(maxsize=1)
def bridged_weights():
    """(pd dict, flax params, flax batch_stats) of the tiny EMRT-R50."""
    shapes = jax.eval_shape(tiny_jax_emrt().init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    pd = synth_pdparams(zeros["params"], zeros["batch_stats"], "EMRT", "resnet50",
                        seed=0)
    params, stats, report = convert_pdparams(pd, zeros["params"],
                                             zeros["batch_stats"], "EMRT", "resnet50")
    assert report["missing"] == [] and report["unused"] == []
    return pd, params, stats


def bridged_state_dict():
    _, params, stats = bridged_weights()
    return state_dict_from_flax(_flat(params), _flat(stats))


def load_checked(module, state_dict, prefix=""):
    """Load the ``prefix`` part of a bridged state dict; every tensor of
    ``module`` but BatchNorm's counters must come from it."""
    sub = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    missing, unexpected = module.load_state_dict(sub, strict=False)
    assert unexpected == []
    assert [k for k in missing if not k.endswith("num_batches_tracked")] == []
    return module.eval()


def tiny_torch_emrt(**kw):
    return EMRT(num_classes=NUM_CLASSES, num_encoder_layers=1,
                num_decoder_layers=1, **kw)


def _images(bs=2, hw=64, seed=1):
    return np.random.default_rng(seed).normal(size=(bs, hw, hw, 3)).astype(np.float32)


def test_tiny_emrt_r50_matches_jax():
    _, params, stats = bridged_weights()
    x = _images()
    want = jax.jit(tiny_jax_emrt().apply, static_argnames="train")(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    model = load_checked(tiny_torch_emrt(), bridged_state_dict())
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.dtype == torch.float32 and g.shape == w.shape == (2, NUM_CLASSES, 64, 64)
        scale = np.abs(w).max()
        assert scale > 0
        assert np.abs(g.numpy() - w).max() <= MODEL_RTOL * scale


def test_pdparams_load_matches_the_flax_bridge():
    """Loading the reference-layout dict directly (UpHead conv biases kept)
    gives the logits of the flax route (biases folded into the BN means)."""
    pd, _, _ = bridged_weights()
    direct = tiny_torch_emrt()
    report = load_pdparams(direct, pd)
    assert report["missing"] == [] and report["unused"] == []
    assert report["matched"] == len(pd) - 1          # all but tgt_embed
    bridged = load_checked(tiny_torch_emrt(), bridged_state_dict())
    x = torch.from_numpy(_images(bs=1).transpose(0, 3, 1, 2))
    with torch.no_grad():
        for a, b in zip(direct.eval()(x), bridged(x)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item())


def test_read_pdparams_reads_a_pickled_state_dict(tmp_path):
    """``paddle.save`` writes a pickle of {name: ndarray}; the reader needs
    no Paddle and hands back the same arrays, which then load as above."""
    pd, _, _ = bridged_weights()
    path = tmp_path / "emrt.pdparams"
    with open(path, "wb") as f:
        pickle.dump(pd, f, protocol=2)
    back = read_pdparams(str(path))
    assert back.keys() == pd.keys()
    for k in pd:
        np.testing.assert_array_equal(back[k], pd[k])
    assert load_pdparams(tiny_torch_emrt(), back)["missing"] == []
    path.write_bytes(pickle.dumps([1, 2, 3]))
    with pytest.raises(ValueError, match="expected a pickled state dict"):
        read_pdparams(str(path))


def test_state_dict_keys_are_the_reference_names():
    keys = set(tiny_torch_emrt().state_dict())
    for k in ("backbone.layer1.0.conv1.weight", "backbone.layer4.0.downsample.1.running_var",
              "model.encoder.layers.0.self_attn.value_proj.weight",
              "model.decoder.layers.0.self_attn.in_proj_weight",
              "model.input_proj.2.1.bias", "spatial_branch.Enc2.encode.4.weight",
              "psp_module.pool_branches.3.1.weight", "EFP.conv0.conv2.0.weight",
              "cls_psp.3.weight", "uphead.conv_0.bias", "uphead.syncbn_fc_2.running_mean",
              "auxlayer.convs.0.0.weight", "auxlayer.conv_seg.bias"):
        assert k in keys, k


def test_bf16_forward_runs_under_autocast():
    model = load_checked(tiny_torch_emrt(dtype=torch.bfloat16), bridged_state_dict())
    ref = load_checked(tiny_torch_emrt(), bridged_state_dict())
    x = torch.from_numpy(_images(bs=1).transpose(0, 3, 1, 2))
    with torch.no_grad():
        got, want = model(x)[0], ref(x)[0]
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    # bf16 keeps ~3 significant digits through 16 bottlenecks and 2 layers
    assert (got - want).abs().max() <= 0.1 * want.abs().max()


@pytest.mark.parametrize("overrides, match", [
    ({"MODEL.NAME": "Segformer"}, "M11"),
    ({"MODEL.NAME": "Segmenter"}, "M11"),
    ({"MODEL.NAME": "PSPNet"}, "not supported"),
    ({"MODEL.ENCODER.TYPE": "swin"}, "backbone swin"),
    ({"MODEL.ENCODER.TYPE": "resnet42"}, "no resnet depth 42"),
    ({"MODEL.OUTPUT_STRIDE": 4}, "output_stride 4"),
])
def test_get_model_refuses_what_is_not_ported(overrides, match):
    cfg = get_config()
    cfg.MODEL.NAME = "EMRT"
    cfg.MODEL.ENCODER.TYPE = "resnet50"
    cfg.MODEL.OUTPUT_STRIDE = 32
    for key, value in overrides.items():
        cfg.merge_from_list([key, str(value)])
    with pytest.raises(NotImplementedError, match=match):
        get_model(cfg)


def test_get_model_reads_dtype_and_classes_from_the_config():
    cfg = get_config()
    cfg.MODEL.NAME = "EMRT"
    cfg.MODEL.ENCODER.TYPE = "resnet18"
    cfg.MODEL.OUTPUT_STRIDE = 32
    cfg.DATA.NUM_CLASSES = 5
    model = get_model(cfg, device="cpu")
    assert model.dtype == torch.bfloat16              # TRAIN.DTYPE default
    assert model.uphead.conv_3.out_channels == 5
    assert model.model.input_proj[0][0].in_channels == 128   # resnet18 c2
