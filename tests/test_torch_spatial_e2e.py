"""Spatial parallelism (PARALLEL.SPATIAL) end to end on gloo ranks on the CPU
(``parallel.launch``; the ranks' halves are in ``test_torch_spatial_ranks.py``):

- the JAX package's spatial step (``create_mesh(data=1, model=1,
  spatial=2)``, ``spatial_batch_sharding``, on two of the host devices, as
  ``tests/test_models.py`` builds it, ``use_pallas=False``) and the port's
  dp1 x sp2 step of the tiny EMRT-R50 from the same bridged weights and
  batch, dropout off: the loss within 1e-5 relative (the bound of
  ``test_torch_train_step.py``);
- ``train.main`` on two ranks with PARALLEL.SPATIAL 2 (resnet18 at 64^2,
  so that 2 divides the 2 rows at stride 32), a save, an eval and
  ``--resume``: equal logged losses and mIoU on both ranks, files from rank
  0 only, and one-process ``val.main`` on its best_model.pt gives the
  run's best mIoU.
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
from emrt_tpu.parallel import create_mesh, replicated, spatial_batch_sharding  # noqa: E402
from emrt_tpu.solver import get_optimizer as jax_optimizer  # noqa: E402
from emrt_tpu.solver import get_scheduler as jax_scheduler  # noqa: E402
from emrt_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from emrt_tpu.train.state import TrainState  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from test_torch_emrt import bridged_state_dict, bridged_weights, tiny_jax_emrt  # noqa: E402
from test_torch_parallel_ranks import FLAGSHIP, SMOKE, train_main_rank  # noqa: E402
from test_torch_spatial_ranks import grid_step_rank  # noqa: E402
from test_torch_spatial_train import _batch  # noqa: E402

from emrt_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from emrt_tpu_torch.val import main as val_main  # noqa: E402

torch.set_num_threads(1)


def test_the_jax_spatial_step_and_the_ports_dp1_x_sp2_step_agree(monkeypatch, tmp_path):
    image, label = _batch(2)
    _, params, stats = bridged_weights()
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    mesh = create_mesh(data=1, model=1, spatial=2, devices=jax.devices()[:2])
    cfg = jax_get_config(str(FLAGSHIP))
    tx = jax_optimizer(cfg, jax_scheduler(cfg), params=params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=tx.init(params), tx=tx)
    state = jax.device_put(state, replicated(mesh))
    batch = jax.device_put({"image": image, "label": label}, spatial_batch_sharding(mesh))
    assert batch["image"].sharding.spec == P("data", "spatial")
    step = jax_make_train_step(tiny_jax_emrt(), jax_loss(cfg), donate=False)
    _, metrics = step(state, batch, jax.random.key(0))
    torch.save(bridged_state_dict(), tmp_path / "bridged.pt")
    ranks = run_ranks(grid_step_rank, 2, args=(1, 2, "r50", str(tmp_path / "bridged.pt"),
                                               image, label, 0.0),
                      timeout=600)
    for got in ranks:
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=1e-5)


def test_train_main_on_two_spatial_ranks_and_val_on_its_checkpoint(tmp_path):
    common = ["--config", str(SMOKE), "--device", "cpu", "--seed", "3"]
    opts = ["SAVE_DIR", str(tmp_path), "TRAIN.DTYPE", "float32", "MODEL.ENCODER.TYPE",
            "resnet18", "DATA.CROP_SIZE", "(64, 64)", "VAL.IMAGE_BASE_SIZE", "64",
            "VAL.CROP_SIZE", "(64, 64)", "VAL.STRIDE_SIZE", "(64, 64)", "DATA.BATCH_SIZE", "2",
            "LOGGING_INFO_FREQ", "1", "SAVE_FREQ_CHECKPOINT", "2", "VALIDATE_FREQ", "2",
            "PARALLEL.SPATIAL", "2"]
    ranks = run_ranks(train_main_rank, 2, args=(
        ["--iters", "2", *common, *opts], ["--iters", "3", "--resume", *common, *opts]),
        timeout=600)
    for r in ranks:
        assert r["first"]["losses"] == ranks[0]["first"]["losses"]
        assert r["second"]["losses"] == ranks[0]["second"]["losses"]
        assert r["first"]["mious"] == ranks[0]["first"]["mious"]
        assert r["second"]["start_iter"] == 2 and r["second"]["last_iter"] == 3
        assert np.isfinite(r["first"]["losses"] + r["second"]["losses"]).all()
    assert ranks[0]["written"] and not ranks[1]["written"]
    best = max(ranks[0]["first"]["mious"] + ranks[0]["second"]["mious"])
    result = val_main(["--config", str(SMOKE), "--device", "cpu", "--model_path",
                       str(tmp_path / "best_model.pt"), *opts[2:-2]])
    assert abs(result["miou"] - best) <= 1e-6
