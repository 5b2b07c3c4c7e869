"""Data-parallel training of the port on two ranks over gloo on the CPU
(``parallel.launch``; the ranks' halves are in ``test_torch_parallel_ranks.py``):

- one train step of the tiny EMRT-R50 of ``test_torch_train_step.py``, two
  ranks of batch 2 (SyncBatchNorm, DDP), against the JAX package's
  ``make_train_step`` with the global batch of 4 placed on a ``data=2``
  mesh (``emrt_tpu.parallel.batch_sharding``), from the same bridged
  weights, with unevenly ignored pixels (one row all ignored). The bounds
  are that file's: the loss 1e-5 relative; each parameter's update within
  0.1 x that tensor's largest update + 1e-2 x the model's largest + two
  float32 spacings of the tensor's largest value + 1e-10; BatchNorm running
  statistics 1e-4 x the tensor's max. The two ranks end bit for bit equal;
- ``train.main`` on two ranks (the smoke yaml, resnet18 at 32^2): only rank 0
  writes files, both log the same global losses, ``--resume`` continues,
  and ``val.main`` in one process on its best_model.pt gives the run's mIoU;
- the same CLIs as a user launches them, ``torchrun --nproc_per_node 2 -m
  emrt_tpu_torch.train`` and ``.val``: the group joined from torchrun's
  environment, the run's checkpoints, and the sharded val's mIoU equal to
  the training run's best.
"""
from __future__ import annotations

import io
import json
import re
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from emrt_tpu.config import get_config as jax_get_config  # noqa: E402
from emrt_tpu.losses import get_loss_function as jax_loss  # noqa: E402
from emrt_tpu.parallel import batch_sharding, create_mesh, replicated  # noqa: E402
from emrt_tpu.solver import get_optimizer as jax_optimizer  # noqa: E402
from emrt_tpu.solver import get_scheduler as jax_scheduler  # noqa: E402
from emrt_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from emrt_tpu.train.state import TrainState  # noqa: E402
from test_pdparams_zoo import _flat  # noqa: E402
from test_torch_emrt import bridged_state_dict, bridged_weights, tiny_jax_emrt  # noqa: E402
from test_torch_parallel_ranks import (FLAGSHIP, SMOKE, train_main_rank,  # noqa: E402
                                       train_step_rank)
from test_torch_slice import ROOT, _clean_env  # noqa: E402

from emrt_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from emrt_tpu_torch.utils.pdparams import state_dict_from_flax  # noqa: E402
from emrt_tpu_torch.val import main as val_main  # noqa: E402

torch.set_num_threads(1)
WORLD = 2


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    label = rng.integers(0, 6, (4, 64, 64))
    shares = np.array([0.1, 0.5, 0.0, 1.0])[:, None, None]
    label = np.where(rng.random((4, 64, 64)) < shares, 255, label).astype(np.int32)
    return image, label


def test_tiny_emrt_dp_train_step_matches_the_jax_data_mesh_step(monkeypatch, tmp_path):
    image, label = _batch()
    _, params, stats = bridged_weights()

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    mesh = create_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    cfg = jax_get_config(str(FLAGSHIP))
    tx = jax_optimizer(cfg, jax_scheduler(cfg), params=params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=tx.init(params), tx=tx)
    state = jax.device_put(state, replicated(mesh))
    batch = jax.device_put({"image": image, "label": label}, batch_sharding(mesh))
    assert len(batch["image"].sharding.device_set) == WORLD
    step = jax_make_train_step(tiny_jax_emrt(), jax_loss(cfg), donate=False)
    new_state, metrics = step(state, batch, jax.random.key(0))
    want = state_dict_from_flax(_flat(jax.device_get(new_state.params)),
                                _flat(jax.device_get(new_state.batch_stats)))

    before = bridged_state_dict()
    torch.save(before, tmp_path / "bridged.pt")
    ranks = run_ranks(train_step_rank, WORLD, args=(str(tmp_path / "bridged.pt"), image, label),
                      timeout=600)
    for got in ranks:
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=1e-5)
        assert got["steps"] == 1
    assert ranks[0]["state"].keys() == ranks[1]["state"].keys()
    for key, value in ranks[0]["state"].items():
        np.testing.assert_array_equal(value, ranks[1]["state"][key], err_msg=key)

    got = ranks[0]["state"]
    assert set(want) <= set(got)
    largest = max((w.double() - before[k].double()).abs().max()
                  for k, w in want.items() if "running" not in k)
    n_params = n_stats = 0
    for key, w in want.items():
        g, b, w = torch.from_numpy(got[key]).double(), before[key].double(), w.double()
        if "running" in key:
            n_stats += 1
            assert (g - w).abs().max() <= 1e-4 * w.abs().max(), key
        else:
            n_params += 1
            ulp = float(np.spacing(np.float32(w.abs().max())))
            bound = 0.1 * (w - b).abs().max() + 1e-2 * largest + 2 * ulp + 1e-10
            assert (g - w).abs().max() <= bound, key
    assert n_params > 250 and n_stats > 100


def test_train_cli_on_two_ranks_writes_on_rank_0_resumes_and_evaluates(tmp_path):
    common = ["--config", str(SMOKE), "--device", "cpu", "SAVE_DIR", str(tmp_path),
              "TRAIN.DTYPE", "float32", "MODEL.ENCODER.TYPE", "resnet18",
              "DATA.CROP_SIZE", "(32, 32)", "VAL.IMAGE_BASE_SIZE", "32",
              "VAL.CROP_SIZE", "(32, 32)", "VAL.STRIDE_SIZE", "(32, 32)",
              "DATA.BATCH_SIZE_VAL", "16", "LOGGING_INFO_FREQ", "1",
              "SAVE_FREQ_CHECKPOINT", "1", "VALIDATE_FREQ", "2", "KEEP_CHECKPOINT_MAX", "1"]
    ranks = run_ranks(train_main_rank, WORLD, args=(["--iters", "2", *common],
                                                    ["--iters", "3", "--resume", *common]),
                      timeout=600)
    first, second = ranks[0]["first"], ranks[0]["second"]
    assert (first["start_iter"], first["last_iter"], first["steps"]) == (0, 2, 2)
    assert (second["start_iter"], second["last_iter"], second["steps"]) == (2, 3, 1)
    assert all(np.isfinite(first["losses"] + second["losses"]))
    for r in ranks[1:]:
        assert r["first"]["losses"] == first["losses"]
        assert r["second"]["losses"] == second["losses"]
        assert r["first"]["mious"] == first["mious"] and r["second"]["mious"] == second["mious"]
    # each rank evaluates 2 of the 4 val batches of 16
    assert first["eval_forwards"] == ranks[1]["first"]["eval_forwards"] == 2
    assert ranks[1]["written"] == []
    assert set(ranks[0]["written"]) == {"iter_1.pt", "iter_2.pt", "iter_3.pt",
                                        "best_model.pt", "best_model.json"}
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == ["iter_3.pt"]
    state = torch.load(tmp_path / "checkpoints" / "iter_3.pt", weights_only=True)
    assert state["step"] == 3 and not any(k.startswith("module.") for k in state["model"])

    best = max(first["mious"] + second["mious"])
    with redirect_stdout(io.StringIO()):
        result = val_main(["--config", str(SMOKE), "--device", "cpu", "--model_path",
                           str(tmp_path / "best_model.pt"), *common[4:]])
    assert result["images"] == 64 and result["miou"] == best


def test_torchrun_launches_the_train_and_val_clis_on_two_ranks(tmp_path):
    common = ["--device", "cpu", "SAVE_DIR", str(tmp_path), "TRAIN.DTYPE", "float32",
              "MODEL.ENCODER.TYPE", "resnet18", "DATA.CROP_SIZE", "(32, 32)",
              "VAL.IMAGE_BASE_SIZE", "32", "VAL.CROP_SIZE", "(32, 32)",
              "VAL.STRIDE_SIZE", "(32, 32)", "DATA.BATCH_SIZE_VAL", "16"]
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(WORLD), "-m"]

    def run(module, *argv):
        proc = subprocess.run([*torchrun, module, "--config", str(SMOKE), *argv],
                              cwd=ROOT, env=_clean_env(), capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        return proc.stdout

    out = run("emrt_tpu_torch.train", "--iters", "2", *common)
    assert f"ranks: {WORLD}" in out and "training done at iter 2" in out
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == ["iter_2.pt"]
    best = json.loads((tmp_path / "best_model.json").read_text())["best_miou"]
    out = run("emrt_tpu_torch.val", "--model_path", str(tmp_path / "best_model.pt"),
              *common)
    # rank 0 alone logs: one table
    assert f"ranks: {WORLD}" in out and out.count("final mIoU") == 1
    assert float(re.search(r"final mIoU: ([0-9.]+)", out).group(1)) == round(best, 4)
