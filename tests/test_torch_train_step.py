"""One whole train step of the port's tiny EMRT-R50 against the JAX
package's ``make_train_step``, from the same bridged weights on the same
batch (the tiny model of ``test_torch_emrt.py``: 1 encoder and 1 decoder
layer, 64^2 input, float32), with the flagship config's solver: SGD with
momentum 0.9, weight decay 1e-4, global-norm clip 1.0, PolynomialDecay and
x0.1 on the deformable offsets and reference points; MixSoftmax CE with
aux weight 0.4. Dropout is off on both sides: ``flax.linen.Dropout`` is made
the identity for the JAX step, and every ``nn.Dropout`` of the port gets
p = 0.

Bounds, each from what float32 allows here:
- loss: 1e-5 relative (it agrees to ~2e-7);
- every parameter's update (new - old): within 0.1 x that tensor's largest
  update + 1e-2 x the largest update of the model + two float32 spacings of
  the tensor's largest value (the resolution of new - old) + 1e-10. flax's
  BatchNorm takes the batch variance in one pass, E[x^2] - E[x]^2, whose
  rounding grows through the backward of 16 bottlenecks to ~1.5% of the
  largest updates (the stem's) and up to ~8% of the smallest (late
  bottlenecks' BatchNorm shifts, ~1% of the largest); the port's own float32
  and float64 gradients differ by ~0.1%. UpHead's conv biases, which the
  JAX package folds into the BatchNorm means, have a gradient that is 0 but
  for rounding (~1e-11 here). The x0.1 lr groups are held exactly in
  test_torch_train.py;
- BatchNorm running statistics: 1e-4 x the tensor's max (they agree to
  ~5e-6; F2's n / (n - 1) would move the 1x1 PSP branches' by ~5%).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from emrt_tpu.config import get_config as jax_get_config  # noqa: E402
from emrt_tpu.losses import get_loss_function as jax_loss  # noqa: E402
from emrt_tpu.solver import get_optimizer as jax_optimizer  # noqa: E402
from emrt_tpu.solver import get_scheduler as jax_scheduler  # noqa: E402
from emrt_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from emrt_tpu.train.state import TrainState  # noqa: E402
from test_pdparams_zoo import _flat  # noqa: E402
from test_torch_emrt import (bridged_state_dict, bridged_weights,  # noqa: E402
                             load_checked, tiny_jax_emrt, tiny_torch_emrt)
from test_torch_train import FLAGSHIP  # noqa: E402

from emrt_tpu_torch.config import get_config  # noqa: E402
from emrt_tpu_torch.losses import get_loss_function  # noqa: E402
from emrt_tpu_torch.solver import get_optimizer, get_scheduler  # noqa: E402
from emrt_tpu_torch.train import make_train_step  # noqa: E402
from emrt_tpu_torch.utils.pdparams import state_dict_from_flax  # noqa: E402

torch.set_num_threads(1)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    label = rng.integers(0, 6, (2, 64, 64))
    label = np.where(rng.random((2, 64, 64)) < 0.1, 255, label).astype(np.int32)
    return image, label


def test_tiny_emrt_train_step_matches_jax(monkeypatch):
    image, label = _batch()
    _, params, stats = bridged_weights()

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    cfg = jax_get_config(str(FLAGSHIP))
    tx = jax_optimizer(cfg, jax_scheduler(cfg), params=params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params), tx=tx)
    step = jax_make_train_step(tiny_jax_emrt(), jax_loss(cfg), donate=False)
    new_state, metrics = step(state, {"image": image, "label": label},
                              jax.random.key(0))
    want = state_dict_from_flax(_flat(new_state.params), _flat(new_state.batch_stats))

    before = bridged_state_dict()
    model = load_checked(tiny_torch_emrt(), bridged_state_dict())
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    pcfg = get_config(str(FLAGSHIP))
    optimizer = get_optimizer(pcfg, model, get_scheduler(pcfg))
    train_step = make_train_step(model, get_loss_function(pcfg), optimizer)
    loss = train_step({"image": torch.from_numpy(image.transpose(0, 3, 1, 2).copy()),
                       "label": torch.from_numpy(label).long()})

    assert loss.dtype == torch.float32 and loss.grad_fn is None
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=1e-5)
    assert optimizer.step_count == 1 and int(new_state.step) == 1
    assert model.training
    got = model.state_dict()
    assert set(want) <= set(got)
    largest = max((w.double() - before[k].double()).abs().max()
                  for k, w in want.items() if "running" not in k)
    n_params = n_stats = 0
    for key, w in want.items():
        g, b = got[key].double(), before[key].double()
        w = w.double()
        if "running" in key:
            n_stats += 1
            assert (g - w).abs().max() <= 1e-4 * w.abs().max(), key
        else:
            n_params += 1
            ulp = float(np.spacing(np.float32(w.abs().max())))
            bound = 0.1 * (w - b).abs().max() + 1e-2 * largest + 2 * ulp + 1e-10
            assert (g - w).abs().max() <= bound, key
    assert n_params > 250 and n_stats > 100
