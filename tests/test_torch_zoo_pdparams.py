"""The zoo's weights and yamls in the port.

- ``load_pdparams`` of each family's reference-layout dict (``synth_pdparams``
  of the JAX model's shapes): nothing missing or unused (DPT's
  ``head.refine.3.resblock1``, which the reference registers but never
  runs, is left unread and unreported), and the logits of the flax route
  (``state_dict_from_flax``) to 1e-5;
- the port's key maps are the JAX package's, family by family;
- ``state_dict_from_flax`` inverts the JAX converter's ConvTranspose flip;
- ``interp_pos_embed`` against the JAX ``_interp_pos_embed`` (1e-6 x
  max|table|: the two sum in another order), and
  the loaders interpolating a table of another size;
- every yaml of the ported families builds through ``get_model`` on the
  meta device, the SegFormer and Segmenter yamls raise naming ROADMAP.md
  queue 1, and the Potsdam yamls' (and SETR-MLA's) parameter counts equal
  the JAX models' (``jax.eval_shape``).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from emrt_tpu.config import get_config as jax_get_config  # noqa: E402
from emrt_tpu.models import get_model as jax_get_model  # noqa: E402
from emrt_tpu.utils import pdparams as jax_pdparams  # noqa: E402
from emrt_tpu.utils.checkpoint import _interp_pos_embed  # noqa: E402
from test_pdparams_zoo import _flat  # noqa: E402
from test_torch_zoo import FAMILIES, bridged, images, nchw, ported, torch_model  # noqa: E402

from emrt_tpu_torch.config import get_config  # noqa: E402
from emrt_tpu_torch.models import get_model  # noqa: E402
from emrt_tpu_torch.utils import pdparams  # noqa: E402
from emrt_tpu_torch.utils.checkpoint import interp_pos_embed, load_weights_auto  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ZOO_DIRS = ("setr", "upernet_swin", "upernet_cswin", "upernet_focal", "dpt", "trans2seg")
ZOO_YAMLS = sorted(f"{d}/{p.name}" for d in ZOO_DIRS for p in (ROOT / "configs" / d).glob("*.yaml"))
WAITING_YAMLS = sorted(f"{d}/{p.name}" for d in ("segformer", "segmenter")
                       for p in (ROOT / "configs" / d).glob("*.yaml"))
# the Potsdam yaml of each family, and the ADE20K SETR-MLA one
COUNTED_YAMLS = ("setr/SETR_PUP_Large_256x256_160k_potsdam_bs_8.yaml",
                 "setr/SETR_Naive_Large_256x256_160k_potsdam_bs_8.yaml",
                 "setr/SETR_MLA_Large_512x512_160k_ade20k_bs_8.yaml",
                 "upernet_swin/upernet_swin_tiny_patch4_windown7_512x512_160k_potsdam.yaml",
                 "upernet_cswin/upernet_cswin_tiny_patch4_512x512_160k_potsdam.yaml",
                 "upernet_focal/upernet_focal_base_patch4_windown7_512x512_160k_potsdam.yaml",
                 "dpt/DPT_Large_512x512_160k_potsdam_bs_8.yaml",
                 "trans2seg/Trans2Seg_medium_256x256_160k_potsdam.yaml")
# registered by the reference, never run (dpt_head.py:144-148)
_DPT_DEAD = {f"head.refine.3.resblock1.{c}.weight": (8, 8, 3, 3) for c in ("conv1", "conv2")}
_DPT_DEAD.update({f"head.refine.3.resblock1.{b}.{s}": (8,) for b in ("bn1", "bn2")
                  for s in ("weight", "bias", "_mean", "_variance")})


@pytest.mark.parametrize("family", list(FAMILIES))
def test_pdparams_load_matches_the_flax_bridge(family):
    pd = dict(bridged(family)[0])
    dead = _DPT_DEAD if family.startswith("dpt") else {}
    rng = np.random.default_rng(2)
    pd.update({k: rng.uniform(0.5, 1.0, s).astype(np.float32) for k, s in dead.items()})
    direct = torch_model(family)
    report = pdparams.load_pdparams(direct, pd)
    assert report["missing"] == [] and report["unused"] == []
    assert report["matched"] == len(pd) - len(dead)
    hw = FAMILIES[family][2]
    x = nchw(images(hw, bs=1))
    with torch.no_grad():
        for a, b in zip(direct.eval()(x), ported(family)(x)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_key_maps_are_the_jax_packages(family):
    name, encoder = FAMILIES[family][:2]
    flat = _flat(bridged(family)[1]["params"])
    pmap, smap, fold, _ = jax_pdparams.build_key_map(flat, name, encoder)
    assert pdparams.build_key_map(flat, name, encoder) == (pmap, smap, fold)
    # and every tensor of the port has its key among the map's targets
    targets = {pdparams._torch_key(pd) for pd, _ in list(pmap.values()) + list(smap.values())}
    keys = {k for k in torch_model(family).state_dict() if not k.endswith("num_batches_tracked")}
    assert keys - targets == ({"head.conv_1.0.bias"} if family == "fcn" else set())
    assert targets <= keys


def test_convt_inverse_of_the_jax_flip():
    """flax kernel = the Paddle/torch [in, out, kh, kw] weight transposed to
    [kh, kw, in, out] and flipped; ``state_dict_from_flax`` undoes both, and
    torch's ConvTranspose2d with the result is the reference's op."""
    import flax.linen as fnn
    rng = np.random.default_rng(0)
    w_pd = rng.normal(size=(3, 5, 4, 4)).astype(np.float32)
    kernel = jax_pdparams._apply("convt", w_pd, np.zeros((4, 4, 3, 5), np.float32))
    state = pdparams.state_dict_from_flax({"process0_up/kernel": kernel}, {}, "DPT", "ViT")
    np.testing.assert_array_equal(state["head.process.0.1.weight"].numpy(), w_pd)
    x = rng.normal(size=(1, 3, 6, 6)).astype(np.float32)
    conv = torch.nn.ConvTranspose2d(3, 5, 4, stride=4, bias=False)
    conv.weight.data = state["head.process.0.1.weight"]
    mod = fnn.ConvTranspose(5, (4, 4), strides=(4, 4), use_bias=False)
    want = mod.apply({"params": {"kernel": jnp.asarray(kernel)}},
                     jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = conv(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src, dst", [(1 + 10 * 10, 1 + 4 * 4), (1 + 4 * 4, 1 + 16 * 16),
                                      (1 + 7 * 7, 1 + 5 * 5), (8 * 8, 4 * 4)])
def test_interp_pos_embed_matches_jax(src, dst):
    value = np.random.default_rng(src).normal(size=(1, src, 8)).astype(np.float32)
    want = _interp_pos_embed(value, (1, dst, 8))
    got = interp_pos_embed(value, (1, dst, 8))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(value).max())
    for fn in (_interp_pos_embed, interp_pos_embed):   # 19 tokens: no square grid
        with pytest.raises(ValueError):
            fn(value, (1, 19, 8))


def test_loaders_interpolate_a_position_table_of_another_size(tmp_path):
    """A SETR trained at 160^2 (a 10 x 10 grid) loads into the 64^2 one,
    from a ``.pdparams`` and from a ``.pt``; the forward still refuses a
    size its table was not made for."""
    key = "encoder.transformer.embeddings.position_embeddings"
    pd = dict(bridged("setr_pup")[0])
    pd[key] = np.random.default_rng(3).normal(size=(1, 101, 32)).astype(np.float32)
    want = interp_pos_embed(pd[key], (1, 17, 32))
    model = torch_model("setr_pup")
    report = pdparams.load_pdparams(model, pd)
    assert report["missing"] == [] and report["unused"] == []
    np.testing.assert_array_equal(model.state_dict()[key].numpy(), want)
    state = model.state_dict()
    state[key] = torch.from_numpy(pd[key])
    torch.save(state, tmp_path / "big.pt")
    other = torch_model("setr_pup")
    report = load_weights_auto(other, str(tmp_path / "big.pt"))
    assert report["missing"] == [] and report["unused"] == []
    np.testing.assert_array_equal(other.state_dict()[key].numpy(), want)
    with pytest.raises(ValueError, match="position table"):
        other(torch.zeros(1, 3, 160, 160))


def test_every_zoo_yaml_is_listed():
    assert len(ZOO_YAMLS) == 51 and len(WAITING_YAMLS) == 23


@pytest.mark.parametrize("yaml", ZOO_YAMLS)
def test_get_model_builds_every_zoo_yaml(yaml):
    cfg = get_config(str(ROOT / "configs" / yaml))
    with torch.device("meta"):
        model = get_model(cfg)
    family = yaml.split("/")[0]
    assert type(model).__name__ == {"setr": "SETR", "dpt": "DPTSeg",
                                    "trans2seg": "Trans2Seg"}.get(family, "UperNet")
    if family == "setr":
        assert model.n_aux == (3 if "Naive" in yaml else 4)
    assert model.dtype == torch.bfloat16 and sum(p.numel() for p in model.parameters()) > 0


@pytest.mark.parametrize("yaml", WAITING_YAMLS)
def test_segformer_and_segmenter_yamls_wait(yaml):
    cfg = get_config(str(ROOT / "configs" / yaml))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        with torch.device("meta"):
            get_model(cfg)


@pytest.mark.parametrize("yaml", COUNTED_YAMLS)
def test_parameter_count_equals_the_jax_models(yaml):
    jcfg = jax_get_config(str(ROOT / "configs" / yaml))
    w, h = jcfg.DATA.CROP_SIZE
    shapes = jax.eval_shape(jax_get_model(jcfg).init, jax.random.key(0),
                            jnp.zeros((1, h, w, 3), jnp.float32))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    with torch.device("meta"):
        model = get_model(get_config(str(ROOT / "configs" / yaml)))
    assert sum(p.numel() for p in model.parameters()) == want
