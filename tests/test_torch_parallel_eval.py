"""Rank-sharded ``evaluate`` of the port (two ranks over gloo on the CPU,
``parallel.launch``; the ranks' half is ``test_torch_parallel_ranks.py::
evaluate_rank``) over 5 images at BATCH_SIZE_VAL 2, crop 64, stride 43,
window batch 2, with a pointwise linear model (6 classes): single-scale
over images of one shape, multi-scale + flip TTA, and images of mixed shapes
(the variable-shape path, whose canvas depends on the batch). Rank r
predicts batches r, r + 2, ...; the two ranks' confusion matrices add up
to the one-process matrix exactly, every rank returns the one-process
areas and metrics exactly, and the mIoU equals the JAX package's mesh
``evaluate`` (``data=2``) with the same model.
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import emrt_tpu.config as jax_config  # noqa: E402
from emrt_tpu.parallel import create_mesh  # noqa: E402
from test_torch_parallel_ranks import LINEAR, ValDataset, evaluate_rank, val_config  # noqa: E402

from emrt_tpu_torch.parallel.launch import run_ranks  # noqa: E402

jax_evaluate = importlib.import_module("emrt_tpu.inference.evaluate")
torch.set_num_threads(1)
WORLD = 2
# case -> (image shapes, TTA scales or None)
CASES = {"uniform": ([(64, 64)] * 5, None),
         "tta": ([(64, 64)] * 5, (0.75, 1.0, 1.25)),
         "mixed shapes": ([(64, 80), (72, 64), (64, 64), (80, 72), (56, 64)], None)}


def _jax_linear(x):
    return jnp.einsum("nhwk,ck->nhwc", x, jnp.asarray(LINEAR))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_evaluate_is_the_one_process_evaluate(case):
    shapes, scales = CASES[case]
    one = evaluate_rank(0, 1, shapes, scales)
    ranks = run_ranks(evaluate_rank, WORLD, args=(shapes, scales), timeout=300)

    assert len(one["cms"]) == 3                         # batches of 2, 2 and 1 (+ a copy)
    assert [len(r["cms"]) for r in ranks] == [2, 1]
    np.testing.assert_array_equal(sum(cm for r in ranks for cm in r["cms"]), sum(one["cms"]))
    assert sum(r["forwards"] for r in ranks) == one["forwards"]
    for r in ranks:
        assert r["areas"] == one["areas"]
        assert r["result"]["images"] == one["result"]["images"] == 5
        for key, value in one["result"].items():
            np.testing.assert_array_equal(r["result"][key], value, err_msg=key)

    cfg = val_config(jax_config, scales)
    want = jax_evaluate.evaluate(_jax_linear, ValDataset(shapes, seed=9), cfg,
                                 multi_scales=bool(scales), window_batch=2,
                                 mesh=create_mesh(data=WORLD, devices=jax.devices()[:WORLD]),
                                 progbar=False)
    assert want["images"] == 5
    for key in ("miou", "acc", "kappa", "mf1"):
        np.testing.assert_allclose(one["result"][key], want[key], rtol=1e-12, err_msg=key)
