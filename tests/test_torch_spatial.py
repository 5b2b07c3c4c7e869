"""Spatial parallelism of the port (``parallel/spatial.py``, PARALLEL.SPATIAL)
op by op, on gloo ranks on the CPU (``parallel.launch``; the ranks' halves
are in ``test_torch_spatial_ranks.py``):

- each halo op of a convolutional EMRT's sharded region (every conv shape
  of a ResNet: the 7x7 s2 stem, 3x3 s2, 3x3, the dilation-2 and -4 3x3s,
  the 1x1 s2 downsample, 1x1; HRNet's TF-style "same" 3x3 s2 conv; the 3x3
  s2 max pool; ResNeSt's 3x3 s2 average pool, its divisor counting the
  padding; uphead's 2x resize, with the edge row at the image's edges;
  HRNet's align_corners=False x2, x4 and x8 upsamples) over S = 2 and 4
  ranks, the align_corners=True resize of a replicated map to the rank's
  rows, ResNeSt's global mean with the gate's BatchNorm1d after it (a
  replicated output, each rank's loss holding an unequal share of its
  gradient), and the transformer backbones' gather of every rank's rows
  (replicated too) and dropout over rows, each over a map whose first row
  spatial rank 0 holds alone (ViT's cls token), against the whole-image op:
  the ranks' outputs and input
  gradients are the whole one's rows (the row resize's input gradients, of
  the replicated map, summed over the ranks; the global mean's outputs the
  whole one's on every rank), their weight gradients sum to the whole
  one's; float32, each within 1e-6 of the whole one's L2 norm, a conv's
  bias gradient within ``BIAS_TOL``;
- a rank's own "same" padding ((0, 1) on every block of an even number of
  rows) is wrong inside the image: its last row must read the next rank's
  first row;
- the grid: rank r = (d * MODEL + m) * SPATIAL + s and its groups;
- ``check_parallel`` accepts SPATIAL 2 for every EMRT (ResNet, ResNeXt,
  ResNeSt, HRNet, CSwin, ViT, SegFormer-B4) at a 256 crop, with MODEL 2 on
  four ranks and with OHEM, and for the zoo's SETR (MLA, PUP, Naive; also
  MODEL 2 x SPATIAL 2), Segmenter (ViT-L, DeiT-B), DPT, SegFormer-B5,
  UperNet (Swin-T, CSwin-T, Focal-B) and Trans2Seg (also MODEL 2 x SPATIAL
  2) at their yamls' crops and FCN at output strides 16 and 8; it refuses
  it where it does not divide the rows at the deepest stride (ViT's and
  Trans2Seg's 16 rows at stride 16 by 3; the others' 8 rows at stride 32 by
  16; DPT's 15 at its 480 crop by 2; UperNet-CSwin's 7 at its 224 crop by
  2), and where a dilated conv's halo is deeper than a rank's rows (an
  EMRT's or FCN's ResNet at output stride 8).

The train step under dp x sp is in ``test_torch_spatial_train.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_parallel_ranks import FLAGSHIP  # noqa: E402
from test_torch_spatial_ranks import (CONVS, OPS, REPLICATED_IN, REPLICATED_OUT, SAME,  # noqa: E402
                                      halo_ops_rank, op_inputs, run_op)

from emrt_tpu_torch.config import get_config  # noqa: E402
from emrt_tpu_torch.models import get_model  # noqa: E402
from emrt_tpu_torch.models.layers import Conv2dSame, halo_rows  # noqa: E402
from emrt_tpu_torch.parallel import check_parallel  # noqa: E402
from emrt_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from emrt_tpu_torch.parallel.mesh import _Grid  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-6
# a conv's bias gradient is a sum of N x H x W float32 terms (768 at stride
# 1), which the ranks and their strips of halo rows add in another order:
# up to 1.44e-6 apart read
BIAS_TOL = 3e-6
CIN_SAME = 3
CONV_NAMES = {name for name, _ in CONVS} | {SAME}
CONFIGS = FLAGSHIP.parents[1]


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
    if name in REPLICATED_OUT:    # every rank holds the whole output
        for r in ranks:
            _close(r["y"], whole["y"], f"{name}: output")
    else:
        _close(np.concatenate([r["y"] for r in ranks], 2), whole["y"], f"{name}: output")
    if name in REPLICATED_IN:     # a replicated input: each rank holds a part of its gradient
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


def test_a_ranks_own_same_padding_is_wrong_inside_the_image():
    """Each block of 8 of 32 rows, run through ``Conv2dSame`` on its own,
    pads (0, 1) as the whole image does; but on the blocks above the last
    the padded row is the next block's first row, so the block's last
    output row differs from the whole image's, and only it."""
    torch.manual_seed(0)
    conv = Conv2dSame(CIN_SAME, 4, 3, 2, 0, 1, 1, bias=True)
    x = torch.randn(2, CIN_SAME, 32, 12)
    with torch.no_grad():
        whole = conv(x)
        for s in range(4):
            own = conv(x[:, :, 8 * s:8 * s + 8])
            want = whole[:, :, 4 * s:4 * s + 4]
            torch.testing.assert_close(own[:, :, :3], want[:, :, :3])
            if s < 3:
                assert (own[:, :, 3] - want[:, :, 3]).abs().max() > 1e-2
            else:
                torch.testing.assert_close(own[:, :, 3], want[:, :, 3])


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
        assert g.gradient_rank == d * 4 + s     # its rows' place in OHEM's flat batch
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


@pytest.mark.parametrize("spatial, model, encoder, stride, name", [
    (2, 1, "resnet50", 32, None), (4, 1, "resnet50", 32, None), (8, 1, "resnet50", 32, None),
    (2, 1, "resnet50", 16, None), (8, 1, "resnet50", 16, None), (2, 1, "resnet50", 8, None),
    (8, 1, "resnet50", 8, None), (2, 2, "resnet50", 32, None), (2, 1, "resnext50", 32, None),
    (2, 1, "resnest50", 32, None), (2, 1, "resnet50", 32, "EMRT_HRNet"),
    (4, 2, "resnet50", 32, "EMRT_HRNet")],
    ids=["os32-s2", "os32-s4", "os32-s8", "os16-s2", "os16-s8", "os8-s2", "os8-s8", "tp-x-sp",
         "resnext", "resnest", "hrnet", "hrnet-tp-x-sp4"])
def test_check_parallel_accepts_spatial_for_a_conv_emrt(spatial, model, encoder, stride, name):
    cfg = _config(SPATIAL=spatial, MODEL=model)
    check_parallel(cfg, 2 * spatial * model, _meta_model(encoder, stride, name))


@pytest.mark.parametrize("spatial, model, encoder, name", [
    (2, 1, "cswintransformer", "EMRT_CSwin"), (2, 1, "vit", "EMRT_ViT"),
    (2, 1, "segformer_b4", None), (2, 2, "vit", "EMRT_ViT")],
    ids=["cswin", "vit", "segformer_b4", "vit-tp-x-sp"])
def test_check_parallel_accepts_spatial_for_a_transformer_emrt(spatial, model, encoder, name):
    cfg = _config(SPATIAL=spatial, MODEL=model)
    check_parallel(cfg, 2 * spatial * model, _meta_model(encoder, 32, name))


@pytest.mark.parametrize("spatial, model, yaml", [
    (2, 1, "setr/SETR_PUP_Large_256x256_160k_potsdam_bs_8.yaml"),
    (2, 1, "setr/SETR_MLA_Large_512x512_160k_ade20k.yaml"),
    (4, 1, "setr/SETR_Naive_Large_768x768_80k_cityscapes.yaml"),
    (2, 2, "setr/SETR_PUP_Large_768x768_80k_cityscapes.yaml"),
    (2, 1, "segmenter/segmenter_Large_512x512_160k_ade20k_bs_16.yaml"),
    (2, 1, "segmenter/segmenter_base_distilled_512x512_160k_ade20k_bs_16.yaml"),
    (2, 1, "dpt/DPT_Large_512x512_160k_potsdam_bs_8.yaml"),
    (2, 1, "segformer/segformer_b5_512x512_160k_ade20k.yaml"),
    (2, 1, "upernet_swin/upernet_swin_tiny_patch4_windown7_512x512_160k_potsdam.yaml"),
    (2, 1, "upernet_cswin/upernet_cswin_tiny_patch4_512x512_160k_potsdam.yaml"),
    (2, 1, "upernet_focal/upernet_focal_base_patch4_windown7_512x512_160k_potsdam.yaml"),
    (2, 1, "trans2seg/Trans2Seg_medium_256x256_160k_potsdam.yaml"),
    (2, 2, "trans2seg/Trans2Seg_medium_256x256_160k_potsdam.yaml"),
    (2, 1, ("resnet50c", 16, "FCN")), (2, 1, ("resnet50c", 8, "FCN"))],
    ids=["setr-pup", "setr-mla", "setr-naive-s4", "setr-tp-x-sp", "segmenter-vit",
         "segmenter-deit", "dpt", "segformer", "upernet-swin", "upernet-cswin", "upernet-focal",
         "trans2seg", "trans2seg-tp-x-sp", "fcn-os16", "fcn-os8"])
def test_check_parallel_accepts_spatial_for_a_global_attention_zoo_model(spatial, model, yaml):
    """Every zoo model: a yaml at its own crop, or FCN (no yaml names it)
    over the flagship's ResNet yaml at an output stride."""
    cfg, meta = _meta_zoo_model(yaml) if isinstance(yaml, str) else (_config(),
                                                                    _meta_model(*yaml))
    cfg.PARALLEL.SPATIAL, cfg.PARALLEL.MODEL = spatial, model
    check_parallel(cfg, 2 * spatial * model, meta)


@pytest.mark.parametrize("overrides, world, model, exc, match", [
    ({"SPATIAL": 16}, 16, ("cswintransformer", 32, "EMRT_CSwin"), ValueError,
     "SPATIAL 16 does not divide the 8 rows of a 256-row crop at output stride 32"),
    ({"SPATIAL": 3}, 3, ("vit", 32, "EMRT_ViT"), ValueError,
     "SPATIAL 3 does not divide the 16 rows of a 256-row crop at output stride 16"),
    ({"SPATIAL": 16}, 16, ("segformer_b4", 32, None), ValueError,
     "SPATIAL 16 does not divide the 8 rows of a 256-row crop at output stride 32"),
    ({"SPATIAL": 2}, 2, "upernet_cswin/upernet_cswin_tiny_patch4_224x224_160k_potsdam.yaml",
     ValueError, "SPATIAL 2 does not divide the 7 rows of a 224-row crop at output stride 32"),
    ({"SPATIAL": 3}, 3, "trans2seg/Trans2Seg_medium_256x256_160k_potsdam.yaml", ValueError,
     "SPATIAL 3 does not divide the 16 rows of a 256-row crop at output stride 16"),
    ({"SPATIAL": 2}, 2, "dpt/DPT_Large_480x480_160k_ade20k.yaml", ValueError,
     "SPATIAL 2 does not divide the 15 rows of a 480-row crop at output stride 32"),
    ({"SPATIAL": 16}, 16, ("resnet50", 32, None), ValueError,
     "SPATIAL 16 does not divide the 8 rows of a 256-row crop at output stride 32"),
    ({"SPATIAL": 3}, 3, ("resnet50", 16, None), ValueError, "does not divide the 16 rows"),
    ({"SPATIAL": 16}, 16, ("resnet50", 8, None), ValueError,
     "the 2 rows a rank holds at output stride 8 are fewer than the halo of its dilation-4"),
    ({"SPATIAL": 16}, 16, ("resnet50c", 8, "FCN"), ValueError,
     "the 2 rows a rank holds at output stride 8 are fewer than the halo of its dilation-4"),
    ({"SPATIAL": 2}, 3, None, ValueError, "PARALLEL.SPATIAL 2 x PARALLEL.MODEL 1 does not "
                                          "divide the 3"),
    ({"SPATIAL": 2, "DATA": 2}, 2, None, ValueError, "use -1 or 1"),
], ids=["cswin", "vit", "segformer_b4", "zoo", "trans2seg", "dpt-480", "os32-rows",
        "os16-rows", "os8-halo", "fcn-os8-halo", "world", "data"])
def test_check_parallel_refuses_what_spatial_cannot_split(overrides, world, model, exc,
                                                          match):
    cfg = _config(**overrides)
    if isinstance(model, str):          # a zoo yaml, at its own crop
        cfg, model = _meta_zoo_model(model)
        for key, value in overrides.items():
            setattr(cfg.PARALLEL, key, value)
    elif model:
        model = _meta_model(*model)
    with pytest.raises(exc, match=match):
        check_parallel(cfg, world, model)


def _meta_zoo_model(yaml):
    """(the config, the model built on the meta device) of a zoo yaml."""
    cfg = get_config(str(CONFIGS / yaml))
    with torch.device("meta"):
        return cfg, get_model(cfg, device="meta")


def test_check_parallel_accepts_ohem_under_spatial():
    cfg = _config(SPATIAL=2)
    cfg.TRAIN.LOSS = "OhemCrossEntropyLoss"
    check_parallel(cfg, 2, _meta_model())
