"""Spatial parallelism (PARALLEL.SPATIAL) of the transformer-backbone EMRTs
(CSwin, ViT, SegFormer-B4's MixViT) on gloo ranks on the CPU
(``parallel.launch``; the ranks' halves are in ``test_torch_spatial_ranks.py``).
Each rank's attentions take its own tokens' queries over the keys and values
gathered from every rank (``SpatialShard.gather_rows``): CSwin's stripes
across the ranks with the padding rows after the image's last row, ViT's
cls token on spatial rank 0, the MixViT's keys and values after its
spatial-reduction convs.

- One train step of each narrow EMRT (``TRANSFORMERS``: CSwin with splits 1,
  2, 7, 7, ViT with a 4 x 4 patch grid, the MixViT with sr ratios 8, 4, 2, 1
  and a block a stage; 1 encoder and 1 decoder layer, from torch's seed 0,
  crop 64) as dp1 x sp2 against one process on the same rows (the batch of
  ``test_torch_spatial_train.py``), dropout 0.1 on every dropout layer and
  the backbones' DropPath at their rates (0.2 for CSwin, 0.1 for the
  MixViT, linear over the blocks; the one-process step drops samples, so a
  rank that drew its own DropPath masks would show): the loss within 1e-6
  relative, the gradient norm within 1e-3, the clipped gradients within
  1e-2 (L2), the BatchNorm running statistics within 1e-5 x each tensor's
  max (``test_torch_spatial_train._failures``), and the two ranks' states
  bit for bit equal;
- the ViT EMRT's step as dp1 x tp2 x sp2 (four ranks: each rank gathers its
  heads' keys and values over its spatial group) with
  ``test_torch_tpsp_train.py``'s checks;
- a planted fault that fails those checks: the backward of the gathers of
  keys and values without the sum over the group (each rank's keys and
  values then get only its own queries' part of their gradient).

The JAX package's spatial step against the port's is in
``test_torch_spatial_transformers_jax.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_spatial_ranks import calls_rank, grid_step_rank, slim_step_rank  # noqa: E402
from test_torch_spatial_train import _assert_ranks_equal, _batch, _failures  # noqa: E402
from test_torch_tpsp_train import _assert_replicated_equal, _partial_apart  # noqa: E402

from emrt_tpu_torch.parallel.launch import run_ranks  # noqa: E402

torch.set_num_threads(1)
DROPOUT = 0.1
KINDS = ("cswin", "vit", "mit")
FAULT = "kv gather without sum"


@functools.lru_cache(maxsize=None)
def _sp2_runs():
    """{(kind, fault): both ranks' results} of the dp1 x sp2 steps, in one
    start of the two ranks (``slim_step_rank``: a faulty step's without
    its whole state)."""
    image, label = _batch(2)
    runs = [(kind, fault) for kind in KINDS for fault in (None, FAULT)]
    calls = [(slim_step_rank, (fault is None, 1, 2, kind, None, image, label, DROPOUT, fault))
             for kind, fault in runs]
    return dict(zip(runs, zip(*run_ranks(calls_rank, 2, args=(calls,), timeout=600))))


@functools.lru_cache(maxsize=None)
def _one(kind):
    image, label = _batch(2)
    return slim_step_rank(0, 1, False, 1, 1, kind, None, image, label, DROPOUT)


@pytest.fixture(scope="module", autouse=True)
def _free_the_steps():
    """The cached steps hold every parameter's gradient: free them once
    this file's tests are done (a worker of the suite runs many files)."""
    yield
    _sp2_runs.cache_clear()
    _one.cache_clear()


@pytest.mark.parametrize("kind", KINDS)
def test_dp1_x_sp2_step_of_the_transformer_emrt_is_one_processs_step(kind):
    ranks = _sp2_runs()[kind, None]
    for got in ranks:
        assert _failures(got, _one(kind), "float32") == []
    _assert_ranks_equal(ranks)
    if kind != "vit":             # the ViT has no DropPath
        assert _one(kind)["dropped_paths"] > 0
        assert all(got["dropped_paths"] == _one(kind)["dropped_paths"] for got in ranks)


@pytest.mark.parametrize("kind", KINDS)
def test_a_kv_gather_without_the_sum_fails_the_checks(kind):
    failures = _failures(_sp2_runs()[kind, FAULT][0], _one(kind), "float32")
    assert any(f.startswith("gradients") for f in failures), failures


def test_dp1_x_tp2_x_sp2_step_of_the_vit_emrt_is_one_processs_step():
    image, label = _batch(2)
    ranks = run_ranks(grid_step_rank, 4, args=(2, 2, "vit", None, image, label, DROPOUT),
                      timeout=600)
    for got in ranks:
        assert _failures(got, _one("vit"), "float32") == []
        assert len(got["partial"]) >= 4 and _partial_apart(got, _one("vit")) <= 1e-2
    _assert_ranks_equal(ranks)
    _assert_replicated_equal(ranks)
    assert max(ranks[0]["spread"].values()) <= 1e-3
