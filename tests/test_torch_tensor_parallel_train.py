"""The data group's semantics and the CLIs under tensor parallelism
(PARALLEL.MODEL), on gloo ranks on the CPU (``parallel.launch``; the ranks'
halves are in ``test_torch_tensor_parallel_ranks.py`` and
``test_torch_parallel_ranks.py``):

- OHEM's k-th probability, MixSoftmax's global mean and ``evaluate``'s
  shards under dp2 x tp2 are those of dp2, bit for bit: the ranks of a model
  group hold the same rows, so a sum over the world instead of the data
  group would double them;
- ``train.main`` on four ranks as dp2 x tp2: only rank 0 writes, the
  checkpoints hold the one-process model's whole tensors and optimizer
  state, ``--resume`` continues from them, ``val.main`` on four ranks with
  PARALLEL.MODEL 2 and in one process on the run's best_model.pt gives the
  run's mIoU.
"""
from __future__ import annotations

import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parallel_ranks import SMOKE, train_main_rank  # noqa: E402
from test_torch_tensor_parallel_ranks import data_group_rank, val_main_rank  # noqa: E402

from emrt_tpu_torch.models.emrt import EMRT  # noqa: E402
from emrt_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from emrt_tpu_torch.val import main as val_main  # noqa: E402

torch.set_num_threads(1)


def _loss_cases(seed=3):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, 6, (4, 8, 8))
    label = np.where(rng.random((4, 8, 8)) < np.array([0.0, 0.3, 0.9, 0.5])[:, None, None],
                     255, label)
    logits = [rng.normal(size=(4, 6, 8, 8)).astype(np.float32) * 3 for _ in range(2)]
    return [("ohem", "OHEM", logits[:1], label), ("mix", "MixSoftmax", logits, label)]


def test_ohem_and_evaluate_under_dp2_x_tp2_are_dp2s():
    shapes = [(64, 64)] * 5 + [(48, 80)] * 3
    args = (_loss_cases(), shapes)
    dp = run_ranks(data_group_rank, 2, args=(1, *args), timeout=300)
    tp = run_ranks(data_group_rank, 4, args=(2, *args), timeout=300)
    for r, got in enumerate(tp):
        want = dp[r // 2]       # rank r = d * 2 + m holds data rank d's rows
        for key in ("ohem", "mix"):
            assert got[key]["loss"] == want[key]["loss"], key
            for g, w in zip(got[key]["grads"], want[key]["grads"]):
                np.testing.assert_array_equal(g, w)
        assert got["seen"] == want["seen"] and got["seen"]
        assert got["evaluate"]["miou"] == want["evaluate"]["miou"]
        assert got["evaluate"]["images"] == len(shapes)
    assert dp[0]["seen"] != dp[1]["seen"]


def test_train_cli_on_dp2_x_tp2_writes_on_rank_0_resumes_and_evaluates(tmp_path):
    common = ["--config", str(SMOKE), "--device", "cpu", "SAVE_DIR", str(tmp_path),
              "TRAIN.DTYPE", "float32", "MODEL.ENCODER.TYPE", "resnet18",
              "DATA.CROP_SIZE", "(32, 32)", "VAL.IMAGE_BASE_SIZE", "32",
              "VAL.CROP_SIZE", "(32, 32)", "VAL.STRIDE_SIZE", "(32, 32)",
              "DATA.BATCH_SIZE_VAL", "16", "LOGGING_INFO_FREQ", "1",
              "SAVE_FREQ_CHECKPOINT", "1", "VALIDATE_FREQ", "2", "KEEP_CHECKPOINT_MAX", "1",
              "PARALLEL.MODEL", "2"]
    ranks = run_ranks(train_main_rank, 4, args=(["--iters", "2", *common],
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
        assert r["written"] == []
    # each data rank evaluates 2 of the 4 val batches of 16, with its model group
    assert [r["first"]["eval_forwards"] for r in ranks] == [2, 2, 2, 2]
    assert set(ranks[0]["written"]) == {"iter_1.pt", "iter_2.pt", "iter_3.pt",
                                        "best_model.pt", "best_model.json"}
    state = torch.load(tmp_path / "checkpoints" / "iter_3.pt", weights_only=True)
    whole = EMRT(num_classes=6, backbone="resnet18", num_encoder_layers=4,
                 num_decoder_layers=2).state_dict()
    assert {k: tuple(v.shape) for k, v in state["model"].items()} == \
        {k: tuple(v.shape) for k, v in whole.items()}
    momentum = state["optimizer"]["sgd"]["state"]
    assert any(tuple(v["momentum_buffer"].shape) == (1024, 256) for v in momentum.values())

    best = max(first["mious"] + second["mious"])
    val_argv = ["--config", str(SMOKE), "--device", "cpu", "--model_path",
                str(tmp_path / "best_model.pt"), *common[4:]]
    split = run_ranks(val_main_rank, 4, args=(val_argv,), timeout=300)
    assert [r["miou"] for r in split] == [best] * 4
    assert [r["images"] for r in split] == [64] * 4 and split[0]["forwards"] == 2
    with redirect_stdout(io.StringIO()):
        result = val_main(val_argv[:-2])
    assert result["images"] == 64 and result["miou"] == best
