"""The EMRT backbone variants train at one image against the JAX
package's EMRT (``test_torch_emrt_variants.VARIANTS``: CSwin, ViT,
HRNet-W48, SegFormer-B4 MixViT, with 1 encoder and 1 decoder layer at 64^2
and that file's bridged weights), and the ResNeSt EMRT, whose split
attention's gate holds a BatchNorm1d over [N, c] vectors (ResNeSt-50's stem
and bottlenecks, one block a stage after the first's two, from flax's own
initial weights), through ``test_torch_batch1.batch1_case``: one train-mode
forward and backward at batch 1, the loss within 1e-5 relative, every
running statistic within 1e-4 x its tensor's max, all gradients within
1e-3 (relative L2), and the pyramid pooling's pool-scale-1 branch (and
ResNeSt's gates) with a gradient of zeros, a tensor, where flax's is 0.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emrt_tpu.models.backbones import resnext as jax_resnext  # noqa: E402
from emrt_tpu.models.emrt import EMRT as JaxEMRT  # noqa: E402
from test_pdparams_zoo import _flat  # noqa: E402
from test_torch_batch1 import batch1_case  # noqa: E402
from test_torch_emrt import NUM_CLASSES, load_checked  # noqa: E402
from test_torch_emrt_variants import HW, VARIANTS, _jax_emrt, _torch_emrt, bridged  # noqa: E402

from emrt_tpu_torch.models import emrt  # noqa: E402
from emrt_tpu_torch.models.backbones import resnet, resnext  # noqa: E402
from emrt_tpu_torch.utils.pdparams import state_dict_from_flax  # noqa: E402

torch.set_num_threads(1)
RESNEST_LAYERS = (2, 1, 1, 1)
# the variants whose gradients are held against JAX's, as in
# ``test_torch_emrt_variants.py``: the JAX gradient of HRNet-W48's and the
# MixViT's EMRTs takes minutes to compile on the CPU
GRADS = ("cswin", "vit")


def _input():
    rng = np.random.default_rng(1)
    image = rng.normal(size=(1, HW, HW, 3)).astype(np.float32)
    label = rng.integers(0, NUM_CLASSES, (1, HW, HW))
    return image, np.where(rng.random((1, HW, HW)) < 0.1, 255, label).astype(np.int32)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_trains_at_batch_1_as_jax(variant):
    name, encoder, _ = VARIANTS[variant]
    _, variables, state = bridged(variant)
    pairs = batch1_case(_jax_emrt(variant), variables, load_checked(_torch_emrt(variant), state),
                        *_input(), name, encoder, grads=variant in GRADS)
    assert any(bn.startswith("psp_module.pool_branches.0.") for bn, _ in pairs), pairs


def test_resnest_emrt_trains_at_batch_1_as_jax(monkeypatch):
    monkeypatch.setattr(jax_resnext, "resnest50", lambda dtype=jnp.float32: jax_resnext._CNNPyramid(
        block="resnest", deep_stem=True, layers=RESNEST_LAYERS, dtype=dtype))
    monkeypatch.setattr(emrt, "resnest50", lambda: resnet.ResNet(
        RESNEST_LAYERS, resnext.ResNeStBottleneck, stem=(32, 32, 64)))
    model = JaxEMRT(num_classes=NUM_CLASSES, backbone="resnest50", num_encoder_layers=1,
                    num_decoder_layers=1, use_pallas=False)
    image, label = _input()
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.key(0), jnp.asarray(image), train=False)
    state = state_dict_from_flax(_flat(variables["params"]), _flat(variables["batch_stats"]),
                                 "EMRT", "resnest50")
    port = load_checked(emrt.EMRT(num_classes=NUM_CLASSES, backbone="resnest50",
                                  num_encoder_layers=1, num_decoder_layers=1), state)
    pairs = batch1_case(model, variables, port, image, label, "EMRT", "resnest50")
    gates = [bn for bn, _ in pairs if bn.endswith("splat.bn")]
    assert gates and all(layer.endswith("splat.fc1") for bn, layer in pairs if bn in gates)
