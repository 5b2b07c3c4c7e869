"""The JAX package's spatial step against the port's for the transformer-backbone
EMRTs (the ranks' halves are in ``test_torch_spatial_ranks.py``): the JAX
step on a ``create_mesh(data=1, model=1, spatial=2)`` mesh with
``spatial_batch_sharding`` on two of the host devices (``use_pallas=False``,
dropout and DropPath off), and the port's dp1 x sp2 step on two gloo ranks,
from the same bridged weights (``test_torch_emrt_variants.bridged``: the
narrow CSwin and ViT EMRTs, 1 encoder and 1 decoder layer, crop 64) and
batch (``test_torch_spatial_train._batch``): the loss within 1e-5 relative.
The SegFormer-B4 EMRT at full width runs under ``-m slow``: its JAX step
compiles for ~100 s on the CPU.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from emrt_tpu.config import get_config as jax_get_config  # noqa: E402
from emrt_tpu.losses import get_loss_function as jax_loss  # noqa: E402
from emrt_tpu.models import layers as jax_layers  # noqa: E402
from emrt_tpu.parallel import create_mesh, replicated, spatial_batch_sharding  # noqa: E402
from emrt_tpu.solver import get_optimizer as jax_optimizer  # noqa: E402
from emrt_tpu.solver import get_scheduler as jax_scheduler  # noqa: E402
from emrt_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from emrt_tpu.train.state import TrainState  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from test_torch_emrt_variants import _jax_emrt, bridged  # noqa: E402
from test_torch_parallel_ranks import FLAGSHIP  # noqa: E402
from test_torch_spatial_ranks import calls_rank, grid_step_rank  # noqa: E402
from test_torch_spatial_train import _batch  # noqa: E402

from emrt_tpu_torch.parallel.launch import run_ranks  # noqa: E402

torch.set_num_threads(1)
NARROW = ("cswin", "vit")


@functools.lru_cache(maxsize=None)
def _port_losses(variants, tmp):
    """{variant: both ranks' logged losses} of the port's dp1 x sp2 steps
    of ``variants`` from the bridged weights (saved under ``tmp``), dropout
    and DropPath off, in one start of the ranks."""
    image, label = _batch(2)
    calls = []
    for variant in variants:
        path = f"{tmp}/{variant}.pt"
        torch.save(bridged(variant)[2], path)
        calls.append((grid_step_rank, (1, 2, variant, path, image, label, 0.0)))
    ranks = run_ranks(calls_rank, 2, args=(calls,), timeout=600)
    return {v: [r[i]["loss"] for r in ranks] for i, v in enumerate(variants)}


@pytest.fixture(scope="module", autouse=True)
def _free_the_steps():
    """Free the port's cached losses and the JAX steps' compiled code once
    this file's tests are done (a worker of the suite runs many files)."""
    yield
    _port_losses.cache_clear()
    jax.clear_caches()


@pytest.mark.parametrize("variant", [*NARROW, pytest.param("segformer", marks=pytest.mark.slow)])
def test_the_jax_spatial_step_and_the_ports_dp1_x_sp2_step_agree(variant, monkeypatch,
                                                                  tmp_path_factory):
    image, label = _batch(2)
    variables = bridged(variant)[1]
    params, stats = variables["params"], variables["batch_stats"]
    for module in (fnn.Dropout, jax_layers.DropPath):
        monkeypatch.setattr(module, "__call__", lambda self, x, *a, **k: x)
    mesh = create_mesh(data=1, model=1, spatial=2, devices=jax.devices()[:2])
    cfg = jax_get_config(str(FLAGSHIP))
    tx = jax_optimizer(cfg, jax_scheduler(cfg), params=params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=tx.init(params), tx=tx)
    state = jax.device_put(state, replicated(mesh))
    batch = jax.device_put({"image": image, "label": label}, spatial_batch_sharding(mesh))
    assert batch["image"].sharding.spec == P("data", "spatial")
    step = jax_make_train_step(_jax_emrt(variant), jax_loss(cfg), donate=False)
    _, metrics = step(state, batch, jax.random.key(0))
    variants = NARROW if variant in NARROW else (variant,)
    losses = _port_losses(variants, str(tmp_path_factory.getbasetemp()))[variant]
    for loss in losses:
        np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=1e-5)
