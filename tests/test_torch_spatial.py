"""Spatial parallelism of the port (``parallel/spatial.py``, PARALLEL.SPATIAL)
op by op, on gloo ranks on the CPU (``parallel.launch``; the ranks' halves
are in ``test_torch_spatial_ranks.py``):

- each halo op of a ResNet EMRT's sharded region (every conv shape: the
  7x7 s2 stem, 3x3 s2, 3x3, the dilation-2 and -4 3x3s, the 1x1 s2
  downsample, 1x1; the 3x3 s2 max pool; uphead's 2x resize, with the edge
  row at the image's edges) over S = 2 and 4 ranks of 16 / S rows, and the
  align_corners=True resize of a replicated map to the rank's rows, against
  the whole-image op: the ranks' outputs and input gradients are the
  whole one's rows (the row resize's input gradients, of the replicated
  map, summed over the ranks), their weight gradients sum to the whole
  one's; float32, each within 1e-6 of the whole one's L2 norm, a conv's
  bias gradient within ``BIAS_TOL``;
- the grid: rank r = (d * MODEL + m) * SPATIAL + s and its groups;
- ``check_parallel`` accepts SPATIAL 2 for the flagship EMRT-R50 at a 256
  crop and refuses it with MODEL > 1, with another backbone, with OHEM,
  where it does not divide the rows at the output stride, and where a
  dilated conv's halo is deeper than a rank's rows.

The train step under dp x sp is in ``test_torch_spatial_train.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_parallel_ranks import FLAGSHIP  # noqa: E402
from test_torch_spatial_ranks import CONVS, OPS, halo_ops_rank, op_inputs, run_op  # noqa: E402

from emrt_tpu_torch.config import get_config  # noqa: E402
from emrt_tpu_torch.models import get_model  # noqa: E402
from emrt_tpu_torch.models.layers import halo_rows  # noqa: E402
from emrt_tpu_torch.parallel import check_parallel  # noqa: E402
from emrt_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from emrt_tpu_torch.parallel.mesh import _Grid  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-6
# a conv's bias gradient is a sum of N x H x W float32 terms (768 at stride
# 1), which the ranks and their strips of halo rows add in another order:
# up to 1.44e-6 apart read
BIAS_TOL = 3e-6
CONV_NAMES = {name for name, _ in CONVS}


@functools.lru_cache(maxsize=None)
def _cases():
    return tuple((name, *op_inputs(name)) for name in OPS)


@functools.lru_cache(maxsize=None)
def _ranks(world):
    return run_ranks(halo_ops_rank, world, args=(_cases(),), timeout=300)


def _close(got, want, what, tol=TOL):
    err = np.linalg.norm((got - want).astype(np.float64)) / np.linalg.norm(want)
    assert err <= tol, f"{what}: {err:.3e} apart (L2, relative)"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", OPS)
def test_a_halo_op_over_the_ranks_is_the_whole_image_op(name, world):
    case = next(c for c in _cases() if c[0] == name)
    whole = run_op(*case)
    ranks = [r[name] for r in _ranks(world)]
    _close(np.concatenate([r["y"] for r in ranks], 2), whole["y"], f"{name}: output")
    if name == "row resize":      # a replicated input: each rank holds a part of its gradient
        grad_x = sum(r["grad_x"] for r in ranks)
    else:
        grad_x = np.concatenate([r["grad_x"] for r in ranks], 2)
    _close(grad_x, whole["grad_x"], f"{name}: input gradient")
    for i, want in enumerate(whole["grad_w"]):
        tol = BIAS_TOL if name in CONV_NAMES and i == 1 else TOL
        _close(sum(r["grad_w"][i] for r in ranks), want, f"{name}: weight gradient {i}", tol)


@pytest.mark.parametrize("kernel, stride, dilation, padding, want", [
    (7, 2, 1, 3, (3, 2)), (3, 2, 1, 1, (1, 0)), (3, 1, 1, 1, (1, 1)), (3, 1, 2, 2, (2, 2)),
    (3, 1, 4, 4, (4, 4)), (1, 2, 1, 0, (0, 0)), (1, 1, 1, 0, (0, 0))])
def test_halo_rows_of_each_conv_shape(kernel, stride, dilation, padding, want):
    assert halo_rows(kernel, stride, dilation, padding) == want


def test_the_grid_is_the_jax_device_arrays_order(monkeypatch):
    """rank r = (d * MODEL + m) * SPATIAL + s: ``np.arange(world).reshape(data,
    model, spatial)`` (no group is made for one rank, so none is here)."""
    import emrt_tpu_torch.parallel.mesh as mesh
    layout = np.arange(8).reshape(2, 1, 4)
    for r in range(8):
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        monkeypatch.setattr(mesh, "world_size", lambda: 8)
        monkeypatch.setattr(mesh.dist, "new_group", lambda ranks: tuple(ranks))
        g = _Grid(1, 4)
        d, m, s = (int(i[0]) for i in np.nonzero(layout == r))
        assert (g.data_rank, g.model_rank, g.spatial_rank) == (d, m, s)
        assert (g.data_world, g.spatial_world, g.gradient_world) == (2, 4, 8)
        assert g.spatial_group == tuple(layout[d, m])
        assert g.data_group == tuple(layout[:, m, s])
        assert g.gradient_group is None          # data x spatial is the world


def _config(**parallel):
    cfg = get_config(str(FLAGSHIP))
    for key, value in parallel.items():
        setattr(cfg.PARALLEL, key, value)
    return cfg


@functools.lru_cache(maxsize=None)
def _meta_model(encoder="resnet50", stride=32, name=None):
    cfg = _config()
    cfg.MODEL.ENCODER.TYPE, cfg.MODEL.OUTPUT_STRIDE = encoder, stride
    if name:
        cfg.MODEL.NAME = name
    return get_model(cfg, device="meta")


@pytest.mark.parametrize("spatial, stride", [(2, 32), (4, 32), (8, 32), (2, 16), (8, 16),
                                             (2, 8), (8, 8)])
def test_check_parallel_accepts_spatial_for_a_resnet_emrt(spatial, stride):
    cfg = _config(SPATIAL=spatial)
    check_parallel(cfg, 2 * spatial, _meta_model(stride=stride))


@pytest.mark.parametrize("overrides, world, model, exc, match", [
    ({"SPATIAL": 2, "MODEL": 2}, 4, None, NotImplementedError, "ROADMAP.md queue 1, item 2"),
    ({"SPATIAL": 2}, 2, ("resnext50", 32, None), NotImplementedError,
     "ROADMAP.md queue 1, items 3-4"),
    ({"SPATIAL": 2}, 2, ("resnet50", 32, "EMRT_HRNet"), NotImplementedError,
     "EMRT with a ResNet backbone only"),
    ({"SPATIAL": 16}, 16, ("resnet50", 32, None), ValueError,
     "SPATIAL 16 does not divide the 8 rows of a 256-row crop at output stride 32"),
    ({"SPATIAL": 3}, 3, ("resnet50", 16, None), ValueError, "does not divide the 16 rows"),
    ({"SPATIAL": 16}, 16, ("resnet50", 8, None), ValueError,
     "the 2 rows a rank holds at output stride 8 are fewer than the halo of its dilation-4"),
    ({"SPATIAL": 2}, 3, None, ValueError, "PARALLEL.SPATIAL 2 x PARALLEL.MODEL 1 does not "
                                          "divide the 3"),
    ({"SPATIAL": 2, "DATA": 2}, 2, None, ValueError, "use -1 or 1"),
], ids=["tp-x-sp", "resnext", "hrnet", "os32-rows", "os16-rows", "os8-halo", "world", "data"])
def test_check_parallel_refuses_what_spatial_cannot_split(overrides, world, model, exc,
                                                          match):
    with pytest.raises(exc, match=match):
        check_parallel(_config(**overrides), world, model and _meta_model(*model))


def test_check_parallel_refuses_ohem_under_spatial():
    cfg = _config(SPATIAL=2)
    cfg.TRAIN.LOSS = "OhemCrossEntropyLoss"
    with pytest.raises(NotImplementedError, match="OhemCrossEntropyLoss"):
        check_parallel(cfg, 2, _meta_model())
