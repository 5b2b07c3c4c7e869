"""Training under spatial parallelism (PARALLEL.SPATIAL) on gloo ranks on the
CPU (``parallel.launch``; the ranks' halves are in
``test_torch_spatial_ranks.py``): one train step of the tiny EMRT-R50 of
``test_torch_train_step.py`` (1 encoder and 1 decoder layer, crop 64, so
that S = 2 divides its 2 rows at stride 32) from the bridged weights, with
the flagship config's solver and loss, dropout 0.1, on a batch whose bottom
rows are more often ignored than its top rows (a per-rank mean shows):

- dp1 x sp2 against one process on the same rows: the loss within 1e-6
  relative, the gradient norm before the clip within 1e-3 and the clipped
  gradients within ``GRAD_RTOL`` (L2), the BatchNorm running statistics
  within 1e-5 x each tensor's max, and the two ranks' states bit for bit
  equal. float32 through BatchNorm on batch statistics amplifies rounding
  (the dropout step's gradients read 1.2e-3 apart, 3.7e-5 without
  dropout); in float64 the same step's gradients agree within 1e-6 (4e-8
  read: the logits leave the model in float32);
- dp1 x sp2 at one image against one process at one image (the pyramid
  pooling's pool-scale-1 branch then has one value a channel), float32 and
  float64, with the same bounds but for the float32 gradient norm, which
  at one image moves with rounding by more than 1e-3 (held to a control);
- dp2 x sp2 on four ranks against dp2 on two (the data ranks draw their
  own dropout masks, so one process cannot draw them), with the same
  bounds;
- planted faults that fail these checks: ``gather_rows``'s backward without
  the sum over the group (each rank keeps only its own loss's part of the
  gradient of the gathered maps), and the sharded region's BatchNorm over
  the data group only (each rank's own rows' statistics). Two other
  forms give the same step (within the bounds): every rank's loss over the
  whole image (the gather's sum counts its gradient S times, and DDP's mean
  over the S ranks divides that out), and the replicated region's BatchNorm
  over the gradient group (its sums and its count are both S times larger);
The JAX package's spatial step and the CLIs under PARALLEL.SPATIAL are in
``test_torch_spatial_e2e.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_emrt import bridged_state_dict  # noqa: E402
from test_torch_spatial_ranks import calls_rank, grid_step_rank  # noqa: E402

from emrt_tpu_torch.parallel.launch import run_ranks  # noqa: E402

torch.set_num_threads(1)
DROPOUT = 0.1
GRAD_RTOL, NORM_RTOL, STATS_TOL = {"float32": 1e-2, "float64": 1e-6}, 1e-3, 1e-5
CONTROL_FACTOR = 5.0
# (fault, dtype) of the dp1 x sp2 runs, in one start of the two ranks
SP2_RUNS = ((None, "float32"), (None, "float64"), ("gather without sum", "float32"),
            ("sharded bn per rank", "float32"), ("full loss", "float32"),
            ("replicated bn over spatial", "float32"), ("one image", "float32"),
            ("one image", "float64"))


def _batch(n):
    rng = np.random.default_rng(0)
    image = rng.normal(size=(n, 64, 64, 3)).astype(np.float32)
    label = rng.integers(0, 6, (n, 64, 64))
    share = np.linspace(0.0, 0.9, n)[:, None, None]
    label = np.where(rng.random((n, 64, 64)) < share, 255, label)
    # the bottom rows (rank 1's under sp2) mostly ignored
    label[:, 40:] = np.where(rng.random((n, 24, 64)) < 0.7, 255, label[:, 40:])
    return image, label.astype(np.int32)


@pytest.fixture(scope="module")
def state_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("bridged") / "bridged.pt"
    torch.save(bridged_state_dict(), path)
    return str(path)


@functools.lru_cache(maxsize=None)
def _sp2_runs(state_path):
    calls = [(grid_step_rank, (1, 2, "r50", state_path, *_batch(1 if fault == "one image" else 2),
                               DROPOUT, None if fault == "one image" else fault, 0, dtype))
             for fault, dtype in SP2_RUNS]
    return dict(zip(SP2_RUNS, zip(*run_ranks(calls_rank, 2, args=(calls,), timeout=600))))


@functools.lru_cache(maxsize=None)
def _one(state_path, dtype, n=2):
    image, label = _batch(n)
    return grid_step_rank(0, 1, 1, 1, "r50", state_path, image, label, DROPOUT, dtype=dtype)


@pytest.fixture(scope="module", autouse=True)
def _free_the_steps():
    """The cached steps hold every parameter's gradient and state, ranks
    by runs: free them once this file's tests are done (a worker of the
    suite runs many files)."""
    yield
    _sp2_runs.cache_clear()
    _one.cache_clear()


def _failures(got, want, dtype, norm_rtol=NORM_RTOL) -> list:
    """The checks of the step ``got`` against ``want`` that it fails."""
    flat = lambda r: np.concatenate([v.ravel() for v in r["grads"].values()])  # noqa: E731
    g, w = flat(got), flat(want)
    stats = max((float(np.abs(got["state"][k] - v).max() / np.abs(v).max())
                 for k, v in want["state"].items() if "running" in k), default=0.0)
    checks = ((abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"]),
               f"loss {got['loss']} vs {want['loss']}"),
              (abs(got["norm"] - want["norm"]) <= norm_rtol * want["norm"],
               f"norm {got['norm']} vs {want['norm']}"),
              (np.linalg.norm(g - w) <= GRAD_RTOL[dtype] * np.linalg.norm(w),
               f"gradients {np.linalg.norm(g - w) / np.linalg.norm(w):.3e} apart (L2)"),
              (stats <= STATS_TOL, f"running statistics {stats:.3e} x max apart"))
    return [what for ok, what in checks if not ok]


def _assert_ranks_equal(ranks):
    for r in ranks[1:]:
        for key, value in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][key], value, err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dp1_x_sp2_step_is_one_processs_step(dtype, state_path):
    ranks = _sp2_runs(state_path)[None, dtype]
    for got in ranks:
        assert _failures(got, _one(state_path, dtype), dtype) == []
    _assert_ranks_equal(ranks)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dp1_x_sp2_step_at_one_image_is_one_processs_step(dtype, state_path):
    """One image a process: the pyramid pooling's pool-scale-1 branch (whole
    on every rank, its BatchNorm on the data group of one rank) sees one
    value a channel, as in one process; its running statistics come out
    equal on the two ranks. At one image the float32 gradient norm moves
    with rounding: one process's lies 2.9e-3 from its own float64 norm here
    (1.3e-4 at two images), so the float32 step's norm is held within
    CONTROL_FACTOR x that distance where it exceeds NORM_RTOL; the float64
    step, within NORM_RTOL and the float64 bounds."""
    want = _one(state_path, dtype, 1)
    norm_rtol = NORM_RTOL
    if dtype == "float32":
        exact = _one(state_path, "float64", 1)["norm"]
        norm_rtol = max(NORM_RTOL, CONTROL_FACTOR * abs(want["norm"] - exact) / exact)
    ranks = _sp2_runs(state_path)["one image", dtype]
    for got in ranks:
        assert _failures(got, want, dtype, norm_rtol) == []
    _assert_ranks_equal(ranks)
    var = "psp_module.pool_branches.0.2.running_var"
    np.testing.assert_array_equal(ranks[0]["state"][var], want["state"][var])


@pytest.mark.parametrize("fault", ["gather without sum", "sharded bn per rank"])
def test_a_planted_fault_fails_the_checks(fault, state_path):
    ranks = _sp2_runs(state_path)[fault, "float32"]
    failures = _failures(ranks[0], _one(state_path, "float32"), "float32")
    assert any(f.startswith("gradients") for f in failures), failures


@pytest.mark.parametrize("form", ["full loss", "replicated bn over spatial"])
def test_the_other_forms_of_the_step_give_the_same_step(form, state_path):
    for got in _sp2_runs(state_path)[form, "float32"]:
        assert _failures(got, _one(state_path, "float32"), "float32") == []


def test_dp2_x_sp2_step_is_the_dp2_step(state_path):
    image, label = _batch(4)
    args = (state_path, image, label, DROPOUT)
    dp = run_ranks(grid_step_rank, 2, args=(1, 1, "r50", *args), timeout=600)
    ranks = run_ranks(grid_step_rank, 4, args=(1, 2, "r50", *args), timeout=600)
    for got in ranks:
        assert _failures(got, dp[0], "float32") == []
    _assert_ranks_equal(ranks)
