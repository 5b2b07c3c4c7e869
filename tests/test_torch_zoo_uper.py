"""The port's UperNet (Swin, CSwin, Focal) against the JAX package's.

The cases and bounds of ``test_torch_zoo.py`` (eval logits, train-mode
loss, eval-mode gradients), and Swin's and Focal's four stage maps at
inputs whose stage grids need padding to the window, within ``TAP_RTOL``
x max|tap|: 96^2 gives stage grids 24/12/6/3 (Swin window 5: padded to 25,
15, 10, then a window of 3; Focal window 5: 25, 15, 10; Focal window 7 with
three focal levels: 28 and 14, the level-2 pooled map trimmed by ``_fit``).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_zoo import (FAMILIES, bridged, cases, check_family, images,  # noqa: E402
                            nchw, ported, torch_model)

TAP_RTOL = 1e-4


@pytest.mark.parametrize("family, check", cases(("upernet_swin", "upernet_cswin",
                                                 "upernet_focal_a", "upernet_focal_b")))
def test_family_matches_jax(family, check):
    check_family(family, check)


@pytest.mark.parametrize("family", ["upernet_swin", "upernet_focal_a", "upernet_focal_b"])
def test_backbone_taps_match_jax(family):
    """The four stage maps at a grid that needs padding. The JAX Swin norms
    its taps itself (``norm{s}``); the port's Swin leaves that to the
    UperNet's ``layer_norms``, as the JAX Focal does."""
    from emrt_tpu.models.backbones.focal import FocalTransformer
    from emrt_tpu.models.backbones.swin import SwinTransformer
    shared = FAMILIES[family][5]
    hw = FAMILIES[family][2]
    _, variables, _ = bridged(family)
    knobs = {k: v for k, v in shared.items()
             if k not in ("encoder_type", "uper_channels", "aux_channels", "drop_path")}
    swin = family == "upernet_swin"
    jcls = SwinTransformer if swin else FocalTransformer
    enc = jcls(drop_path_rate=0.0, **knobs)
    x = images(hw, seed=5)
    want = jax.jit(enc.apply)({"params": variables["params"]["encoder"]}, jnp.asarray(x))
    model = ported(family)
    with torch.no_grad():
        got = model.encoder(nchw(x))
        if swin:
            got = [n(f.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                   for n, f in zip(model.layer_norms, got)]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= TAP_RTOL * np.abs(w).max()


def test_padding_and_levels_are_exercised():
    """The settings above pad the stage grids and, for Focal B, pool at a
    second level through the centre trim."""
    swin = torch_model("upernet_swin").encoder
    assert [(b.ws, b.shift, b.mask_hw) for b in (swin.stages[0].blocks[1],
                                                   swin.stages[1].blocks[1])] == \
        [(5, 2, (25, 25)), (5, 2, (15, 15))]
    assert swin.stages[3].blocks[0].ws == 3
    focal_b = torch_model("upernet_focal_b").encoder
    blk = focal_b.layers[0].blocks[0]
    assert (blk.ws, blk.attn.e, blk.wsg, blk.attn.levels) == (7, 3, [7, 3],
                                                             ((3, 1, 3), (5, 2, 4)))
    assert blk.attn.pooled_hw == ((4, 4), (8, 8))           # 28 / 7, trimmed to 24 / 3
    assert focal_b.layers[2].blocks[0].ws == 6 and focal_b.layers[2].blocks[0].attn.e == 0
