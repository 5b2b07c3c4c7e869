"""Spatial parallelism (PARALLEL.SPATIAL) of the zoo (SETR MLA / PUP / Naive,
DPT, the Segmenter with ViT or DeiT and the mask transformer or the linear
decoder, SegFormer, UperNet with Swin, CSwin or Focal, FCN, Trans2Seg) on
gloo ranks on the CPU (``parallel.launch``; the ranks' halves are in
``test_torch_spatial_ranks.py``). All but Trans2Seg run whole on a rank's
image rows: the backbone's attentions over keys and values gathered from
the group (Swin's and Focal's windows of the rank's rows over the gathered
normed map), the prefix tokens on spatial rank 0, the heads' convs through
halos and their resizes through ``layers.upsample``; DPT's readout reads
rank 0's cls token on every rank, the mask transformer's class tokens run
replicated and the UperHead's pyramid bins pool its gathered top map.
Trans2Seg's ResNet and head run on the rank's rows, its transformer whole
over the gathered c4.

- One train step of each narrow zoo family of ``test_torch_zoo.FAMILIES``
  (crop 64, Swin's and Focal's tables built for it, from torch's seed 0;
  FCN also at output stride 8, its dilation-4 halo the 4 rows a rank
  holds) as dp1 x sp2 against one process on the same rows (the batch of
  ``test_torch_spatial_train.py``), dropout 0.1 on every dropout layer
  (Swin's and Focal's window dropouts too) and DropPath at 0.1 where the
  model has one (SegFormer, UperNet): the loss within 1e-6 relative, the
  gradient norm within 1e-3, the clipped gradients within 1e-2 (L2; 1e-6
  for the ResNet-50c models, which run in float64: ``DTYPES``), the
  BatchNorm running statistics within 1e-5 x each tensor's max
  (``test_torch_spatial_train._failures``), and the two ranks' states bit
  for bit equal;
- SETR-PUP's and Trans2Seg's steps as dp1 x tp2 x sp2 (four ranks: each
  rank gathers its heads' keys and values, or Trans2Seg's c4, over its
  spatial group) with ``test_torch_tpsp_train.py``'s checks (12 and 4
  split parameters, none read on a head slice);
- planted faults that fail those checks: DPT's readout taking each rank's
  first token (a patch token off rank 0), the mask transformer gathering
  its class tokens' keys and values with the patches', the heads' resizes
  over the rank's rows alone, Swin's windows over the rank's rows alone
  (no neighbour rows, no wrap), the pyramid bins pooled over the rank's
  rows, and Trans2Seg's decoder over the rank's tokens alone;
- ``SpatialShard.upsample_rows`` with align_corners=True at factors 2 and 4
  and ``SpatialShard.lead_tokens`` over 2 and 4 ranks against the whole
  image's op and its gradients (``test_torch_spatial.py``'s bounds).

The JAX package's spatial step against the port's is in
``test_torch_spatial_zoo_jax.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_spatial import TOL, _close  # noqa: E402
from test_torch_spatial_ranks import (REPLICATED_OUT, ZOO_OPS, calls_rank,  # noqa: E402
                                      grid_step_rank, halo_ops_rank, op_inputs, run_op,
                                      slim_step_rank)
from test_torch_spatial_train import _assert_ranks_equal, _batch, _failures  # noqa: E402
from test_torch_tpsp_train import _assert_replicated_equal  # noqa: E402
from test_torch_zoo import FAMILIES  # noqa: E402

from emrt_tpu_torch.parallel.launch import run_ranks  # noqa: E402

torch.set_num_threads(1)
DROPOUT = 0.1
DROP_PATH = 0.1            # SegFormer's, as its yamls set MODEL.DROP_PATH
CROP = 64
ZOO = ("setr_mla", "setr_pup", "setr_naive", "dpt_project", "dpt_add", "segmenter_vit_mask",
       "segmenter_deit_mask", "segmenter_vit_linear", "segformer", "upernet_swin",
       "upernet_cswin", "upernet_focal_a", "upernet_focal_b", "trans2seg", "fcn", "fcn_os8")
# families of ``test_torch_zoo.FAMILIES`` with other arguments: (family, arguments)
VARIANTS = {"fcn_os8": ("fcn", {"output_stride": 8})}
# the steps of the ResNet-50c models run in float64: at crop 64 their float32
# steps read 4e-6 apart in the loss and 3e-5 x max in the running statistics
# (BatchNorm over 32 values a channel at stride 16 amplifies the halo
# strips' other rounding), their float64 ones within 3.5e-8 in the norm, as
# ``test_torch_spatial_backbones.py``'s ResNeSt-50
DTYPES = {"trans2seg": "float64", "fcn": "float64", "fcn_os8": "float64"}
# (fault, family) of the planted faults' dp1 x sp2 steps
FAULTS = (("cls on every rank", "dpt_project"), ("class tokens gathered", "segmenter_vit_mask"),
          ("class tokens gathered", "segmenter_deit_mask"), ("resize over own rows", "setr_mla"),
          ("resize over own rows", "setr_pup"), ("resize over own rows", "dpt_add"),
          ("resize over own rows", "segmenter_vit_linear"), ("resize over own rows", "segformer"),
          ("windows over own rows", "upernet_swin"), ("psp over own rows", "upernet_cswin"),
          ("decoder over own tokens", "trans2seg"))


def spec(family):
    """(the port's class, its arguments) of a narrow family (or of
    VARIANTS') built for the CROP, its DropPath (SegFormer's, UperNet's) at
    DROP_PATH."""
    family, extra = VARIANTS.get(family, (family, {}))
    _, _, _, _, cls, shared, _, torch_kw = FAMILIES[family]
    kw = {**shared, **torch_kw, **extra}
    if "drop_path" in kw:
        kw["drop_path"] = DROP_PATH
    if "img_size" in kw:
        kw["img_size"] = (CROP, CROP)
    return cls, kw


def dtype(family) -> str:
    return DTYPES.get(family, "float32")


@functools.lru_cache(maxsize=None)
def _sp2_runs():
    """{(family, fault): both ranks' results} of the dp1 x sp2 steps, in one
    start of the two ranks (``slim_step_rank``: a faulty step's without its
    whole state)."""
    image, label = _batch(2)
    runs = [(family, None) for family in ZOO] + [(family, fault) for fault, family in FAULTS]
    calls = [(slim_step_rank, (fault is None, 1, 2, spec(family), None, image, label, DROPOUT,
                               fault, 0, dtype(family))) for family, fault in runs]
    return dict(zip(runs, zip(*run_ranks(calls_rank, 2, args=(calls,), timeout=600))))


@functools.lru_cache(maxsize=None)
def _one(family):
    image, label = _batch(2)
    return slim_step_rank(0, 1, False, 1, 1, spec(family), None, image, label, DROPOUT, None,
                          0, dtype(family))


@functools.lru_cache(maxsize=None)
def _op_ranks(world):
    return run_ranks(halo_ops_rank, world, args=(tuple((n, *op_inputs(n)) for n in ZOO_OPS),),
                     timeout=300)


@pytest.fixture(scope="module", autouse=True)
def _free_the_steps():
    """The cached steps hold every parameter's gradient: free them once
    this file's tests are done (a worker of the suite runs many files)."""
    yield
    _sp2_runs.cache_clear()
    _one.cache_clear()
    _op_ranks.cache_clear()


@pytest.mark.parametrize("family", ZOO)
def test_dp1_x_sp2_step_of_a_zoo_model_is_one_processs_step(family):
    ranks = _sp2_runs()[family, None]
    for got in ranks:
        assert _failures(got, _one(family), dtype(family)) == []
    _assert_ranks_equal(ranks)
    if family == "segformer":
        assert _one(family)["dropped_paths"] > 0
        assert all(got["dropped_paths"] == _one(family)["dropped_paths"] for got in ranks)


@pytest.mark.parametrize("fault, family", FAULTS, ids=[f"{f}-{m}" for f, m in FAULTS])
def test_a_planted_fault_fails_the_checks(fault, family):
    failures = _failures(_sp2_runs()[family, fault][0], _one(family), dtype(family))
    assert any(f.startswith("gradients") for f in failures), failures


def _tpsp_step(family, n_split):
    """``family``'s dp1 x tp2 x sp2 step (four ranks: each rank gathers its
    heads' keys and values, or Trans2Seg's c4, over its spatial group) with
    ``test_torch_tpsp_train.py``'s checks: ``n_split`` split parameters,
    none read on a head slice."""
    image, label = _batch(2)
    args = (spec(family), None, image, label, DROPOUT, None, 0, dtype(family))
    ranks = run_ranks(grid_step_rank, 4, args=(2, 2, *args), timeout=600)
    one = grid_step_rank(0, 1, 1, 1, *args)
    for got in ranks:
        assert _failures(got, one, dtype(family)) == []
        assert len(one["grads"]) - len(got["replicated"]) == n_split
        assert got["partial"] == []
    _assert_ranks_equal(ranks)
    _assert_replicated_equal(ranks)
    assert max(ranks[0]["spread"].values()) <= 1e-3


def test_dp1_x_tp2_x_sp2_step_of_setr_pup_is_one_processs_step():
    # the ViT's 4 attentions split (qkv weight and bias, the output
    # projection's weight)
    _tpsp_step("setr_pup", 4 * 3)


def test_dp1_x_tp2_x_sp2_step_of_trans2seg_is_one_processs_step():
    # the encoder's 2 attentions split (the bias-free qkv's weight, the
    # projection's weight), over the gathered c4 of each spatial group
    _tpsp_step("trans2seg", 2 * 2)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ZOO_OPS)
def test_a_zoo_collective_over_the_ranks_is_the_whole_image_op(name, world):
    whole = run_op(name, *op_inputs(name))
    ranks = [r[name] for r in _op_ranks(world)]
    if name in REPLICATED_OUT:    # every rank holds rank 0's lead tokens
        for r in ranks:
            np.testing.assert_array_equal(r["y"], whole["y"])
    else:
        _close(np.concatenate([r["y"] for r in ranks], 2), whole["y"], f"{name}: output")
    _close(np.concatenate([r["grad_x"] for r in ranks], 2), whole["grad_x"],
           f"{name}: input gradient")
    for i, want in enumerate(whole["grad_w"]):
        _close(sum(r["grad_w"][i] for r in ranks), want, f"{name}: weight gradient {i}", TOL)
