"""The JAX package's spatial step against the port's for the zoo's
global-attention models (the ranks' halves are in
``test_torch_spatial_ranks.py``): the JAX step on a ``create_mesh(data=1,
model=1, spatial=2)`` mesh with ``spatial_batch_sharding`` on two of the
host devices (GSPMD partitions the whole model over the image rows;
dropout off), and the port's dp1 x sp2 step on two gloo ranks, from the
same bridged weights (``test_torch_zoo.bridged`` at crop 64: the narrow
SETR-MLA, DPT with the ``project`` readout, the DeiT Segmenter with the
mask transformer, SegFormer, UperNet with Swin and with Focal, Trans2Seg
and FCN) and batch (``test_torch_spatial_train._batch``),
with the flagship config's solver and loss: the loss within 1e-5 relative.
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
from emrt_tpu.parallel import create_mesh, replicated, spatial_batch_sharding  # noqa: E402
from emrt_tpu.solver import get_optimizer as jax_optimizer  # noqa: E402
from emrt_tpu.solver import get_scheduler as jax_scheduler  # noqa: E402
from emrt_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from emrt_tpu.train.state import TrainState  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from test_torch_parallel_ranks import FLAGSHIP  # noqa: E402
from test_torch_spatial_ranks import calls_rank, grid_step_rank  # noqa: E402
from test_torch_spatial_train import _batch  # noqa: E402
from test_torch_zoo import FAMILIES, bridged, jax_model  # noqa: E402

from emrt_tpu_torch.parallel.launch import run_ranks  # noqa: E402

torch.set_num_threads(1)
JAX_ZOO = ("setr_mla", "dpt_project", "segmenter_deit_mask", "segformer", "upernet_swin",
           "upernet_focal_a", "trans2seg", "fcn")
CROP = 64


def _spec(family):
    _, _, _, _, cls, shared, _, torch_kw = FAMILIES[family]
    kw = {**shared, **torch_kw}
    if "img_size" in kw:
        kw["img_size"] = (CROP, CROP)
    return cls, kw


def _bridged(family):
    return bridged(family, CROP)


@functools.lru_cache(maxsize=None)
def _port_losses(tmp):
    """{family: both ranks' logged losses} of the port's dp1 x sp2 steps of
    JAX_ZOO from the bridged weights (saved under ``tmp``), dropout and
    DropPath off, in one start of the ranks."""
    image, label = _batch(2)
    calls = []
    for family in JAX_ZOO:
        path = f"{tmp}/{family}.pt"
        torch.save(_bridged(family)[2], path)
        calls.append((grid_step_rank, (1, 2, _spec(family), path, image, label, 0.0)))
    ranks = run_ranks(calls_rank, 2, args=(calls,), timeout=600)
    return {f: [r[i]["loss"] for r in ranks] for i, f in enumerate(JAX_ZOO)}


@pytest.fixture(scope="module", autouse=True)
def _free_the_steps():
    """Free the port's cached losses, the bridged weights and the JAX steps'
    compiled code once this file's tests are done (a worker of the suite
    runs many files)."""
    yield
    _port_losses.cache_clear()
    bridged.cache_clear()
    jax.clear_caches()


@pytest.mark.parametrize("family", JAX_ZOO)
def test_the_jax_spatial_step_and_the_ports_dp1_x_sp2_step_agree(family, monkeypatch,
                                                                 tmp_path_factory):
    image, label = _batch(2)
    variables = _bridged(family)[1]
    params, stats = variables["params"], variables["batch_stats"]
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    mesh = create_mesh(data=1, model=1, spatial=2, devices=jax.devices()[:2])
    cfg = jax_get_config(str(FLAGSHIP))
    tx = jax_optimizer(cfg, jax_scheduler(cfg), params=params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=tx.init(params), tx=tx)
    state = jax.device_put(state, replicated(mesh))
    batch = jax.device_put({"image": image, "label": label}, spatial_batch_sharding(mesh))
    assert batch["image"].sharding.spec == P("data", "spatial")
    step = jax_make_train_step(jax_model(family), jax_loss(cfg), donate=False)
    _, metrics = step(state, batch, jax.random.key(0))
    for loss in _port_losses(str(tmp_path_factory.getbasetemp()))[family]:
        np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=1e-5)
