"""Every family of the port's zoo trains at one image against the JAX
package's (``test_torch_zoo.FAMILIES``: FCN, SETR, UperNet with Swin, CSwin
and Focal, DPT, Trans2Seg, SegFormer, the Segmenter; their narrow widths
and bridged weights), through ``test_torch_batch1.batch1_case``: one
train-mode forward and backward at batch 1, the loss within 1e-5
relative, every running statistic within 1e-4 x its tensor's max; where a
BatchNorm sees one value a channel (the UperHead's pool-scale-1 bin) its
weight's and its conv's gradients a tensor of zeros, and for the narrow
UperNet-CSwin all gradients within 1e-3 (relative L2) of JAX's.

FCN and Trans2Seg end in a ResNet-50c whose last BatchNorms see 16 values
a channel at batch 1 (4 x 4 maps): there the JAX package's one-pass
variance, E[x^2] - E[x]^2, cancels in float32 (FCN's float32 loss read
2.3e-5 from the port's float64 one, the port's float32 3.2e-6), so their
reference takes flax's two-pass variance, as torch does.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_batch1 import batch1_case  # noqa: E402
from test_torch_zoo import FAMILIES, X64, bridged, images, jax_model, ported  # noqa: E402

torch.set_num_threads(1)
TWO_PASS = ("fcn", "trans2seg")
# the families whose UperHead has a pool-scale-1 bin: one value a channel;
# the narrow UperNet-CSwin's gradients held against JAX's (the JAX gradients
# of the others take 10-25 s each to compile)
ONE_VALUE = ("upernet_swin", "upernet_cswin", "upernet_focal_a", "upernet_focal_b")
GRADS = ("upernet_cswin",)


def _label(hw):
    rng = np.random.default_rng(4)
    label = rng.integers(0, 6, (1, hw, hw))
    return np.where(rng.random((1, hw, hw)) < 0.1, 255, label).astype(np.int32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_trains_at_batch_1_as_jax(family):
    name, encoder, hw = FAMILIES[family][:3]
    pairs = batch1_case(jax_model(family), bridged(family)[1], ported(family),
                        images(hw, bs=1), _label(hw), name, encoder, grads=family in GRADS,
                        x64=family in X64, two_pass=family in TWO_PASS)
    assert bool(pairs) == (family in ONE_VALUE), pairs
