"""Spatial parallelism (PARALLEL.SPATIAL) of the HRNet and ResNeSt EMRTs and of
OHEM, on gloo ranks on the CPU (``parallel.launch``; the ranks' halves are
in ``test_torch_spatial_ranks.py``):

- one train step of a narrow HRNet EMRT (width 8, one module a stage: its
  four branches at strides 4 to 32, the "same" convs, the fuse's and the
  concat's x2 to x8 upsamples, ``input_proj`` in the sharded region) and
  of the ResNeSt-50 EMRT (the split-attention global means and their
  gate's BatchNorm1d, the padding-counting average pools), each with 1
  encoder and 1 decoder layer from torch's seed 0, crop 64 (one row a rank
  at stride 32), dropout 0.1, as dp1 x sp2 against one process on the same
  rows (the batch of ``test_torch_spatial_train.py``): the loss within 1e-6
  relative, the gradient norm within 1e-3, the clipped gradients within
  1e-2 (L2; 1e-6 in float64), the BatchNorm running statistics within 1e-5
  x each tensor's max, and the two ranks' states bit for bit equal. The
  ResNeSt step runs in float64: at this size float32 is far from exact
  arithmetic in one process already (``scripts/torch_resnest_precision.py``
  reads it). Against one process's float64 step
  (gradient norm 1.39e5, dropout off; 7.48e4 with dropout 0.1), one
  process's float32 step read a norm of 5.9e4 (2.1e5 with dropout), its
  gradients 1.9 apart (L2; 0.50) and its loss 1.2e-3 apart (1.7e-3); the
  dp1 x sp2 float32 step read 1.8e5 (9.9e4), 0.41 (1.9) and 1.1e-3
  (3.8e-3). The sharded float32 step lands as far from exact as one
  process's does, so no float32 bound can tell them apart; in float64 the
  two agree within the bounds above (norm 6e-7, gradients 4e-7);
- OHEM (thresh 0.7) over dp1 x sp2 and dp2 x sp2 against one process, at
  a ``min_kept`` whose k-th true-class probability is above the threshold
  (so the k-th of the global flat batch decides what is kept): the logged
  loss within 1e-6 relative and the logits' gradients within 1e-6 of the
  largest.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_spatial_ranks import BACKBONES, calls_rank, grid_step_rank, ohem_rank  # noqa: E402
from test_torch_spatial_train import _assert_ranks_equal, _batch, _failures  # noqa: E402

from emrt_tpu_torch.parallel.launch import run_ranks  # noqa: E402

torch.set_num_threads(1)
DROPOUT = 0.1
MIN_KEPT = 7000          # of the 8192 pixels of 2 x 64 x 64
DTYPES = {"hrnet": "float32", "resnest": "float64"}


def _ohem_case(n=2, seed=4):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(n, 6, 64, 64)) * 3).astype(np.float32)
    label = rng.integers(0, 6, (n, 64, 64))
    label = np.where(rng.random((n, 64, 64)) < 0.1, 255, label).astype(np.int32)
    return logits, label


@functools.lru_cache(maxsize=None)
def _sp2_runs():
    image, label = _batch(2)
    logits, ohem_label = _ohem_case()
    calls = [(grid_step_rank, (1, 2, kind, None, image, label, DROPOUT, None, 0, DTYPES[kind]))
             for kind in BACKBONES]
    calls.append((ohem_rank, (2, logits, ohem_label, MIN_KEPT)))
    return list(zip(*run_ranks(calls_rank, 2, args=(calls,), timeout=600)))


@functools.lru_cache(maxsize=None)
def _one(kind):
    image, label = _batch(2)
    return grid_step_rank(0, 1, 1, 1, kind, None, image, label, DROPOUT, dtype=DTYPES[kind])


@pytest.fixture(scope="module", autouse=True)
def _free_the_steps():
    """The cached steps hold every parameter's gradient and state, ranks
    by runs: free them once this file's tests are done (a worker of the
    suite runs many files)."""
    yield
    _sp2_runs.cache_clear()
    _one.cache_clear()


@pytest.mark.parametrize("kind", list(BACKBONES))
def test_dp1_x_sp2_step_of_the_emrt_is_one_processs_step(kind):
    ranks = _sp2_runs()[list(BACKBONES).index(kind)]
    for got in ranks:
        assert _failures(got, _one(kind), DTYPES[kind]) == []
    _assert_ranks_equal(ranks)


def test_ohems_min_kept_binds_here():
    """The k-th smallest true-class probability of the flat batch is above
    the threshold: the k-th decides what is kept."""
    logits, label = _ohem_case()
    t = torch.from_numpy(logits).softmax(1)
    safe = torch.from_numpy(np.where(label == 255, 0, label)).long()
    prob = t.gather(1, safe[:, None])[:, 0]
    prob = torch.where(torch.from_numpy(label) == 255, 1.0, prob).flatten()
    assert torch.kthvalue(prob, MIN_KEPT).values > 0.7


@pytest.mark.parametrize("grid", ["dp1 x sp2", "dp2 x sp2"])
def test_ohem_over_the_spatial_ranks_is_one_processs(grid):
    if grid == "dp1 x sp2":
        logits, label = _ohem_case()
        ranks = _sp2_runs()[-1]
    else:
        logits, label = _ohem_case(4)
        ranks = run_ranks(ohem_rank, 4, args=(2, logits, label, 2 * MIN_KEPT), timeout=300)
    one = ohem_rank(0, 1, 1, logits, label, MIN_KEPT if grid == "dp1 x sp2" else 2 * MIN_KEPT)
    n_data = len(ranks) // 2
    for r, got in enumerate(ranks):
        assert abs(got["loss"] - one["loss"]) <= 1e-6 * abs(one["loss"])
    # rank r = d * 2 + s: data rank d's images, their rows block s
    grad = np.concatenate([np.concatenate([ranks[d * 2 + s]["grad"] for s in range(2)], 2)
                           for d in range(n_data)], 0)
    assert np.abs(grad - one["grad"]).max() <= 1e-6 * np.abs(one["grad"]).max()
