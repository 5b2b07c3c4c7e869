"""Tensor x spatial parallelism (PARALLEL.MODEL x PARALLEL.SPATIAL) on four gloo
ranks on the CPU (``parallel.launch``; the ranks' halves are in
``test_torch_spatial_ranks.py``): one train step of the tiny EMRT-R50 (1
encoder and 1 decoder layer, float32, crop 64, so that S = 2 divides its 2
rows at stride 32) from the bridged weights, with the flagship config's
solver and loss, as dp1 x tp2 x sp2: the transformer split over each model
group, the image rows over each spatial group, DDP over the gradient group
(the two spatial ranks of equal model rank) and ``GradientSync`` over the
model group (the two model ranks of equal spatial rank).

- With dropout 0.1, against one process on the same rows (the batch of
  ``test_torch_spatial_train.py``, whose bottom rows are more often
  ignored): the loss within 1e-6 relative, the gradient norm before the
  clip within 1e-3, the clipped gradients, the split ones gathered over the
  model group, within 1e-2 (L2), the BatchNorm running statistics within
  1e-5 x each tensor's max (``test_torch_spatial_train._failures``), and the
  four ranks' gathered states and their own replicated parameters bit for
  bit equal; the gradients of the replicated parameters that the split
  layers read on a head slice (``TP_PARTIAL``, summed over the model group)
  within 1e-2 (L2);
- a planted fault that fails those checks: ``GradientSync`` over the whole
  world instead of the model group (the head-sliced replicated gradients
  summed over the spatial ranks a second time, twice their size);
- the JAX package's step on a ``create_mesh(data=1, model=2, spatial=2)``
  mesh with ``tp_shard_params`` and ``spatial_batch_sharding``, as
  ``__graft_entry__.py::_dryrun_dp_tp_sp`` builds it (``use_pallas=False``,
  dropout off), against the port's dp1 x tp2 x sp2 step from the same
  bridged weights and batch: the loss within 1e-5 relative.
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
from emrt_tpu.parallel import (create_mesh, replicated, spatial_batch_sharding,  # noqa: E402
                               tp_shard_params)
from emrt_tpu.solver import get_optimizer as jax_optimizer  # noqa: E402
from emrt_tpu.solver import get_scheduler as jax_scheduler  # noqa: E402
from emrt_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from emrt_tpu.train.state import TrainState  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from test_torch_emrt import bridged_state_dict, bridged_weights, tiny_jax_emrt  # noqa: E402
from test_torch_parallel_ranks import FLAGSHIP  # noqa: E402
from test_torch_spatial_ranks import calls_rank, grid_step_rank  # noqa: E402
from test_torch_spatial_train import _assert_ranks_equal, _batch, _failures  # noqa: E402

from emrt_tpu_torch.parallel.launch import run_ranks  # noqa: E402

torch.set_num_threads(1)
DROPOUT = 0.1
# (dropout, fault) of the dp1 x tp2 x sp2 runs, in one start of the four ranks
RUNS = ((DROPOUT, None), (DROPOUT, "sync over the world"), (0.0, None))


@pytest.fixture(scope="module")
def state_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("bridged") / "bridged.pt"
    torch.save(bridged_state_dict(), path)
    return str(path)


@functools.lru_cache(maxsize=None)
def _tpsp_runs(state_path):
    image, label = _batch(2)
    calls = [(grid_step_rank, (2, 2, "r50", state_path, image, label, dropout, fault))
             for dropout, fault in RUNS]
    return dict(zip(RUNS, zip(*run_ranks(calls_rank, 4, args=(calls,), timeout=600))))


@functools.lru_cache(maxsize=None)
def _one(state_path):
    image, label = _batch(2)
    return grid_step_rank(0, 1, 1, 1, "r50", state_path, image, label, DROPOUT)


def _assert_replicated_equal(ranks):
    for r in ranks[1:]:
        for key, value in ranks[0]["replicated"].items():
            np.testing.assert_array_equal(r["replicated"][key], value, err_msg=key)


def _partial_apart(got, want) -> float:
    """The L2 distance of the ``TP_PARTIAL`` gradients of ``got`` from
    ``want``'s, relative to ``want``'s."""
    g, w = (np.concatenate([r["grads"][k].ravel() for k in got["partial"]])
            for r in (got, want))
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def test_dp1_x_tp2_x_sp2_step_is_one_processs_step(state_path):
    ranks = _tpsp_runs(state_path)[DROPOUT, None]
    for got in ranks:
        assert _failures(got, _one(state_path), "float32") == []
        assert len(got["partial"]) >= 4 and _partial_apart(got, _one(state_path)) <= 1e-2
    _assert_ranks_equal(ranks)
    _assert_replicated_equal(ranks)
    # the replicated gradients of a model group differed before the
    # optimizer gave them model rank 0's by summation order only
    assert max(ranks[0]["spread"].values()) <= 1e-3


def test_gradient_sync_over_the_world_fails_the_checks(state_path):
    ranks = _tpsp_runs(state_path)[DROPOUT, "sync over the world"]
    failures = _failures(ranks[0], _one(state_path), "float32")
    assert any(f.startswith("gradients") for f in failures), failures
    assert _partial_apart(ranks[0], _one(state_path)) > 0.5


def test_the_jax_tp_x_sp_step_and_the_ports_agree(monkeypatch, state_path):
    image, label = _batch(2)
    _, params, stats = bridged_weights()
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    mesh = create_mesh(data=1, model=2, spatial=2, devices=jax.devices()[:4])
    cfg = jax_get_config(str(FLAGSHIP))
    sharded = tp_shard_params(params, mesh)
    tx = jax_optimizer(cfg, jax_scheduler(cfg), params=sharded)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=sharded,
                       batch_stats=jax.device_put(stats, replicated(mesh)),
                       opt_state=tx.init(sharded), tx=tx)
    batch = jax.device_put({"image": image, "label": label}, spatial_batch_sharding(mesh))
    assert batch["image"].sharding.spec == P("data", "spatial")
    step = jax_make_train_step(tiny_jax_emrt(), jax_loss(cfg), donate=False)
    _, metrics = step(state, batch, jax.random.key(0))
    ranks = _tpsp_runs(state_path)[0.0, None]
    for got in ranks:
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=1e-5)

