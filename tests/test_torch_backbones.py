"""Each backbone of the port against its JAX module, one set of weights.

The JAX module is initialised at a small width and every leaf is then moved
by seeded noise (biases, norm scales and BatchNorm statistics included, so
that none sits at its init); ``state_dict_from_flax`` carries the weights
into the port's module under the EMRT prefix its map uses. In eval mode and
float32 every tap must agree within 1e-4 x its largest value: the two sides
differ only in the order of float32 sums.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import flax.traverse_util as tu  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from emrt_tpu.models.backbones import cswin as jax_cswin  # noqa: E402
from emrt_tpu.models.backbones import hrnet as jax_hrnet  # noqa: E402
from emrt_tpu.models.backbones import mix_transformer as jax_mit  # noqa: E402
from emrt_tpu.models.backbones import resnet as jax_resnet  # noqa: E402
from emrt_tpu.models.backbones import resnext as jax_resnext  # noqa: E402
from emrt_tpu.models.backbones import vit as jax_vit  # noqa: E402
from test_pdparams_zoo import _flat  # noqa: E402
from test_torch_emrt import load_checked  # noqa: E402

from emrt_tpu_torch.models.backbones import cswin, hrnet, mix_transformer, resnet, resnext, vit  # noqa: E402,E501
from emrt_tpu_torch.models.layers import Conv2dSame  # noqa: E402
from emrt_tpu_torch.utils.pdparams import state_dict_from_flax  # noqa: E402

torch.set_num_threads(1)
TAP_RTOL = 1e-4


def jitter(variables, seed=0):
    """Every leaf of flax ``variables`` moved by seeded noise; variances
    drawn from [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    out = {}
    for col in ("params", "batch_stats"):
        flat = _flat(variables.get(col, {}))
        for k, v in flat.items():
            if k.endswith("/var"):
                flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                flat[k] = (v + rng.normal(scale=0.05, size=v.shape)).astype(np.float32)
        out[col] = flat
    return out


def _taps(out):
    """Flatten (c1, [maps], ...) / [maps] into a list of arrays."""
    taps = []
    for o in out:
        taps += list(o) if isinstance(o, (list, tuple)) else [o]
    return taps


# name -> (JAX module, port module, MODEL.NAME, encoder type, port prefix, (h, w))
CASES = {
    "resnet50_os16": (lambda: jax_resnet.ResNet(layers=(2, 2, 2, 2), output_stride=16),
                      lambda: resnet.ResNet((2, 2, 2, 2), output_stride=16),
                      "EMRT", "resnet50", "backbone.", (64, 64)),
    "resnet50_os8": (lambda: jax_resnet.ResNet(layers=(2, 2, 2, 2), output_stride=8),
                     lambda: resnet.ResNet((2, 2, 2, 2), output_stride=8),
                     "EMRT", "resnet50", "backbone.", (64, 64)),
    "resnet50c": (lambda: jax_resnet.ResNet(layers=(2, 2, 2, 2), deep_stem=True),
                  lambda: resnet.ResNet((2, 2, 2, 2), stem=(64, 64, 128)),
                  "EMRT", "resnet50c", "backbone.", (64, 64)),
    "resnet18_os8_deep": (lambda: jax_resnet.ResNet(layers=(2, 2, 2, 2), block="basic",
                                                    deep_stem=True, output_stride=8),
                          lambda: resnet.ResNet((2, 2, 2, 2), resnet.BasicBlock,
                                                (64, 64, 128), 8),
                          "EMRT", "resnet18c", "backbone.", (64, 64)),
    "resnext50": (lambda: jax_resnext._CNNPyramid(block="resnext", layers=(2, 1, 1, 1)),
                  lambda: resnet.ResNet((2, 1, 1, 1), resnext.ResNeXtBottleneck),
                  "EMRT", "resnext50", "backbone.", (64, 64)),
    "resnest50": (lambda: jax_resnext._CNNPyramid(block="resnest", deep_stem=True,
                                                  layers=(2, 1, 1, 1)),
                  lambda: resnet.ResNet((2, 1, 1, 1), resnext.ResNeStBottleneck,
                                        (32, 32, 64)),
                  "EMRT", "resnest50", "backbone.", (64, 64)),
    "hrnet": (lambda: jax_hrnet.HRNet(width=8, stage_modules=(1, 1, 1)),
              lambda: hrnet.HRNet(width=8, stage_modules=(1, 1, 1)),
              "EMRT_HRNet", "HRNet", "backbone.", (64, 64)),
    "mit": (lambda: jax_mit.MixVisionTransformer(depths=(1, 1, 1, 1)),
            lambda: mix_transformer.MixVisionTransformer(depths=(1, 1, 1, 1)),
            "EMRT", "segformer_b4", "backbone.backbone.", (64, 64)),
    "cswin": (lambda: jax_cswin.CSwinTransformer(embed_dim=16, depths=(1, 1, 1, 1),
                                                 split_sizes=(1, 2, 2, 2)),
              lambda: cswin.CSwinTransformer(16, (1, 1, 1, 1), (2, 4, 8, 16), (1, 2, 2, 2)),
              "EMRT_CSwin", "CSwinTransformer", "encoder.", (64, 64)),
    # maps of 20x16, 10x8, 5x4, 3x2 against splits 1, 3, 3, 2: stages 2-4 pad
    # before qkv, the last stage's single branch too
    "cswin_padded": (lambda: jax_cswin.CSwinTransformer(embed_dim=16, depths=(1, 1, 1, 1),
                                                        split_sizes=(1, 3, 3, 2)),
                     lambda: cswin.CSwinTransformer(16, (1, 1, 1, 1), (2, 4, 8, 16),
                                                    (1, 3, 3, 2)),
                     "EMRT_CSwin", "CSwinTransformer", "encoder.", (80, 64)),
    "vit": (lambda: jax_vit.VisionTransformer(hidden_size=64, num_layers=4, num_heads=4,
                                              out_indices=(0, 1, 2, 3)),
            lambda: vit.VisionTransformer((64, 64), 16, 64, 4, 4, out_indices=(0, 1, 2, 3)),
            "EMRT_ViT", "ViT", "encoder.transformer.", (64, 64)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_backbone_matches_jax(case):
    make_jax, make_torch, model_name, encoder_type, prefix, (h, w) = CASES[case]
    jmod = make_jax()
    x = np.random.default_rng(1).normal(size=(2, h, w, 3)).astype(np.float32)
    variables = jax.jit(jmod.init)(jax.random.key(0), jnp.asarray(x[:1]))
    weights = jitter(variables)
    want = jax.jit(jmod.apply, static_argnames="train")(
        {col: tu.unflatten_dict(v, sep="/") for col, v in weights.items()}, jnp.asarray(x),
        train=False)
    state = state_dict_from_flax(*({f"backbone/{k}": v for k, v in weights[col].items()}
                                   for col in ("params", "batch_stats")),
                                 model_name, encoder_type)
    port = load_checked(make_torch(), state, prefix)
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    got, want = _taps(got), _taps(want)
    assert len(got) == len(want) >= 4
    for i, (g, wt) in enumerate(zip(got, want)):
        wt = np.asarray(wt).transpose(0, 3, 1, 2)
        assert g.shape == wt.shape, (i, g.shape, wt.shape)
        scale = np.abs(wt).max()
        assert scale > 0
        err = np.abs(g.numpy() - wt).max()
        assert err <= TAP_RTOL * scale, (case, i, err, scale)


@pytest.mark.parametrize("size, kernel, stride", [
    (8, 3, 2), (7, 3, 2), (9, 2, 2), (10, 4, 4), (6, 3, 1)])
def test_conv_same_pads_as_flax(size, kernel, stride):
    """TF-style "SAME": out = ceil(in / stride), the odd pixel at the end
    ((0, 1) for k3 s2 on an even map)."""
    x = np.random.default_rng(0).normal(size=(1, size, size + 1, 3)).astype(np.float32)
    conv = fnn.Conv(4, (kernel, kernel), strides=stride, padding="SAME")
    variables = conv.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(conv.apply(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    port = Conv2dSame(3, 4, kernel, stride)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(
            np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        port.bias.zero_()
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
