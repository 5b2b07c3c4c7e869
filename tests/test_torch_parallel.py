"""The port's data parallelism (``emrt_tpu_torch/parallel``) against the JAX
package's global-batch semantics, on two ranks over gloo on the CPU (each a
spawned process with one thread and a file store, ``parallel.launch``;
their halves are in ``test_torch_parallel_ranks.py``), from seeded numpy
inputs:

- SyncBatchNorm2d / 1d on each rank's rows against the port's BatchNorm on
  the whole batch and against flax ``BatchNorm`` on it: outputs, input and
  affine gradients, running statistics, within 1e-5 relative (float32);
  with no process group they are BatchNorm2d / 1d bit for bit;
- CE, MixSoftmax, MultiCE and OHEM with unevenly ignored pixels, one case
  with a rank whose pixels are all ignored: the ranks' mean loss and their
  logits' gradients (divided by the world size: DDP averages) against the
  JAX loss of the global batch, within 1e-6 relative;
- the train CLI's loader on each rank against the JAX ``DataLoader`` of
  the same shard, bit for bit;
- a PARALLEL.SPATIAL or PARALLEL.MODEL that does not divide one process
  and a PARALLEL.DATA other than the world are refused, and the step seed
  folds in the rank only with two or more;
- the models that leave a parameter without a gradient in a train step,
  for which DDP must look for unused parameters, are the ones that say so
  (a forward and backward of each family's yaml at full width on the meta
  device).
"""
from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import emrt_tpu.config as jax_config  # noqa: E402
from emrt_tpu.data.datasets import SyntheticDataset as JaxSynthetic  # noqa: E402
from emrt_tpu.data.loader import DataLoader as JaxDataLoader  # noqa: E402
from emrt_tpu.data.transforms import get_transforms as jax_transforms  # noqa: E402
from emrt_tpu.losses import (CrossEntropyLoss, MixSoftmaxCrossEntropyLoss,  # noqa: E402
                             MultiCrossEntropyLoss, OhemCrossEntropyLoss)
from test_torch_parallel_ranks import (SMOKE, loader_rank, losses_rank, rows,  # noqa: E402
                                       sync_bn_rank)

from emrt_tpu_torch.config import get_config  # noqa: E402
from emrt_tpu_torch.losses import get_loss_function  # noqa: E402
from emrt_tpu_torch.models import get_model  # noqa: E402
from emrt_tpu_torch.models.layers import BatchNorm1d, BatchNorm2d  # noqa: E402
from emrt_tpu_torch.parallel import (SyncBatchNorm1d, SyncBatchNorm2d,  # noqa: E402
                                     check_parallel, convert_sync_batchnorm, is_distributed)
from emrt_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from emrt_tpu_torch.train.cli import step_seed  # noqa: E402
from emrt_tpu_torch.train import main as train_main  # noqa: E402
from emrt_tpu_torch.val import main as val_main  # noqa: E402

torch.set_num_threads(1)
WORLD = 2
RTOL = 1e-5


def _close(got, want, rtol=RTOL, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30), err_msg=what)


# -------------------------------------------------------------- SyncBatchNorm

def _bn_inputs(kind, seed=0):
    rng = np.random.default_rng(seed)
    shape = (4, 5, 6, 7) if kind == "2d" else (6, 5)
    # an offset per channel, as convolution outputs have
    x = (rng.normal(size=shape) * 2.0 + rng.normal(size=(1, 5) + (1,) * (len(shape) - 2))
         ).astype(np.float32)
    grad_y = rng.normal(size=shape).astype(np.float32)
    weight = rng.normal(size=5).astype(np.float32)
    bias = rng.normal(size=5).astype(np.float32)
    return x, grad_y, weight, bias


@pytest.fixture(scope="module")
def sync_bn_runs():
    return {kind: run_ranks(sync_bn_rank, WORLD, args=_bn_inputs(kind), timeout=300)
            for kind in ("2d", "1d")}


def _torch_bn(kind, x, grad_y, weight, bias, cls=None):
    """(module, output, input gradient) of the port's BatchNorm (or ``cls``)
    on the whole batch in training mode."""
    cls = cls or (BatchNorm2d if kind == "2d" else BatchNorm1d)
    bn = cls(x.shape[1], eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn.train()(xt)
    y.backward(torch.from_numpy(grad_y))
    return bn, y.detach(), xt.grad


def _flax_bn(x, grad_y, weight, bias):
    """flax BatchNorm (momentum 0.9 = torch's 0.1) on the whole batch, the
    channels last: (output, input gradient, affine gradients, mean, var)."""
    to_last = (lambda a: a.transpose(0, 2, 3, 1)) if x.ndim == 4 else (lambda a: a)
    from_last = (lambda a: a.transpose(0, 3, 1, 2)) if x.ndim == 4 else (lambda a: a)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.key(0), jnp.asarray(to_last(x)))
    params = {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}

    def apply(params, xin):
        return bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xin,
                        mutable=["batch_stats"])

    y, pull, stats = jax.vjp(apply, params, jnp.asarray(to_last(x)), has_aux=True)
    g_params, g_x = pull(jnp.asarray(to_last(grad_y)))
    s = stats["batch_stats"]
    return (from_last(np.asarray(y)), from_last(np.asarray(g_x)), np.asarray(g_params["scale"]),
            np.asarray(g_params["bias"]), np.asarray(s["mean"]), np.asarray(s["var"]))


@pytest.mark.parametrize("kind", ["2d", "1d"])
def test_sync_batchnorm_on_two_ranks_is_batchnorm_of_the_global_batch(kind, sync_bn_runs):
    """Each rank's output and input gradient are its rows of the whole
    batch's; the sum of the ranks' affine gradients (what DDP's average
    turns into the global loss's) and every rank's running statistics are
    the whole batch's: against the port's BatchNorm and flax's."""
    x, grad_y, weight, bias = _bn_inputs(kind)
    ranks = sync_bn_runs[kind]
    bn, y, grad_x = _torch_bn(kind, x, grad_y, weight, bias)
    fy, fgx, fgw, fgb, fmean, fvar = _flax_bn(x, grad_y, weight, bias)
    for name, want_y, want_gx, want_gw, want_gb, want_mean, want_var in (
            ("port", y.numpy(), grad_x.numpy(), bn.weight.grad.numpy(), bn.bias.grad.numpy(),
             bn.running_mean.numpy(), bn.running_var.numpy()),
            ("flax", fy, fgx, fgw, fgb, fmean, fvar)):
        for r, got in enumerate(ranks):
            part = rows(len(x), r, WORLD)
            _close(got["y"], want_y[part], what=f"{name} output, rank {r}")
            _close(got["grad_x"], want_gx[part], what=f"{name} input grad, rank {r}")
            _close(got["running_mean"], want_mean, what=f"{name} running mean, rank {r}")
            _close(got["running_var"], want_var, what=f"{name} running var, rank {r}")
            assert got["num_batches_tracked"] == 1
        _close(sum(g["grad_weight"] for g in ranks), want_gw, what=f"{name} weight grad")
        _close(sum(g["grad_bias"] for g in ranks), want_gb, what=f"{name} bias grad")


@pytest.mark.parametrize("kind", ["2d", "1d"])
def test_sync_batchnorm_without_a_process_group_is_batchnorm(kind):
    """One process: the converted layer takes BatchNorm's own path, bit for
    bit (output, gradients, running statistics), in training and eval."""
    assert not is_distributed()
    x, grad_y, weight, bias = _bn_inputs(kind, seed=1)
    sync = SyncBatchNorm2d if kind == "2d" else SyncBatchNorm1d
    a, ya, gxa = _torch_bn(kind, x, grad_y, weight, bias)
    b, yb, gxb = _torch_bn(kind, x, grad_y, weight, bias, cls=sync)
    for u, v in ((ya, yb), (gxa, gxb), (a.weight.grad, b.weight.grad),
                 (a.bias.grad, b.bias.grad), (a.running_mean, b.running_mean),
                 (a.running_var, b.running_var)):
        assert torch.equal(u, v)
    xt = torch.from_numpy(x)
    assert torch.equal(a.eval()(xt), b.eval()(xt))


def test_convert_sync_batchnorm_keeps_parameters_buffers_and_keys():
    from emrt_tpu_torch.models.emrt import EMRT
    model = EMRT(num_classes=6, backbone="resnest50", num_encoder_layers=1,
                 num_decoder_layers=1)
    params = dict(model.named_parameters())
    keys = list(model.state_dict())
    n2 = sum(type(m) is BatchNorm2d for m in model.modules())
    n1 = sum(type(m) is BatchNorm1d for m in model.modules())
    assert n2 > 50 and n1 > 0
    assert convert_sync_batchnorm(model) is model
    assert sum(type(m) is SyncBatchNorm2d for m in model.modules()) == n2
    assert sum(type(m) is SyncBatchNorm1d for m in model.modules()) == n1
    assert not any(type(m) in (BatchNorm2d, BatchNorm1d) for m in model.modules())
    assert list(model.state_dict()) == keys
    assert all(p is params[k] for k, p in model.named_parameters())


# ---------------------------------------------------------------------- losses

def _loss_cases():
    """(key, name, global NCHW logits, global labels) for every loss and
    ignore layout: rank 0's rows 20% / 70% ignored and rank 1's 0% / 40%
    ("uneven"), or rank 1's all ignored ("one rank all ignored")."""
    rng = np.random.default_rng(3)
    n, c, h, w = 4, 6, 9, 7
    logits = [(rng.normal(size=(n, c, h, w)) * 3).astype(np.float32) for _ in range(3)]
    label = rng.integers(0, c, (n, h, w))
    u = rng.random((n, h, w))
    cases = []
    for layout, shares in (("uneven", (0.2, 0.7, 0.0, 0.4)),
                           ("one rank all ignored", (0.2, 0.7, 1.0, 1.0))):
        lab = np.where(u < np.asarray(shares)[:, None, None], 255, label).astype(np.int32)
        for name, k in (("CE", 1), ("MixSoftmax", 2), ("MultiCE", 3), ("OHEM", 1)):
            cases.append((f"{name}, {layout}", name, logits[:k], lab))
    return cases


def _jax_loss(name):
    return {"CE": lambda: CrossEntropyLoss(255),
            "MixSoftmax": lambda: MixSoftmaxCrossEntropyLoss(255, aux=True, aux_weight=0.4),
            "MultiCE": lambda: MultiCrossEntropyLoss(255, weights=(1, 0.4, 0.4)),
            "OHEM": lambda: OhemCrossEntropyLoss(255, thresh=0.3, min_kept=40)}[name]()


@pytest.fixture(scope="module")
def loss_runs():
    return run_ranks(losses_rank, WORLD, args=(_loss_cases(),), timeout=300)


@pytest.mark.parametrize("key", [case[0] for case in _loss_cases()])
def test_losses_on_two_ranks_are_the_global_batch_loss(key, loss_runs):
    """Every rank reports the JAX loss of the global batch; each rank's
    logits gradient, over the world size, is the JAX loss's gradient on its
    rows (an all-ignored rank's is 0)."""
    _, name, logits, label = next(c for c in _loss_cases() if c[0] == key)
    loss_fn = _jax_loss(name)

    def f(*nchw):
        return loss_fn([jnp.transpose(a, (0, 2, 3, 1)) for a in nchw], jnp.asarray(label))

    want, grads = jax.value_and_grad(f, argnums=tuple(range(len(logits))))(
        *[jnp.asarray(a) for a in logits])
    ranks = [r[key] for r in loss_runs]
    _close(np.mean([r["loss"] for r in ranks]), float(want), rtol=1e-6, what="mean loss")
    for r, got in enumerate(ranks):
        _close(got["reported"], float(want), rtol=1e-6, what=f"reported loss, rank {r}")
        part = rows(len(label), r, WORLD)
        for i, (g, wg) in enumerate(zip(got["grads"], grads)):
            wg = np.asarray(wg)[part]
            np.testing.assert_allclose(g / WORLD, wg, rtol=1e-6,
                                       atol=1e-6 * np.abs(np.asarray(grads[i])).max(),
                                       err_msg=f"logits {i} grad, rank {r}")
            if (label[part] == 255).all():
                assert not g.any()


# ---------------------------------------------------------------------- loader

@pytest.mark.parametrize("start_iter", [0, 3])
def test_train_loader_of_each_rank_is_the_jax_loaders_shard(start_iter):
    """The train CLI's loader (``make_train_loader``) reads its rank and the
    world from the process group: rank r's batches are the JAX DataLoader's
    with shard_index=r, num_shards=2, bit for bit (NCHW here)."""
    ranks = run_ranks(loader_rank, WORLD, args=(2, 7, 11, start_iter), timeout=300)
    jcfg = jax_config.get_config(str(SMOKE))
    jcfg.DATA.CROP_SIZE = (16, 16)
    jds = JaxSynthetic(jax_transforms(jcfg), num_samples=10, crop_size=(16, 16))
    for r, got in enumerate(ranks):
        want = list(JaxDataLoader(jds, 2, iterations=7, seed=11, num_workers=3,
                                  start_iter=start_iter, shard_index=r, num_shards=WORLD))
        assert len(got) == len(want) == 7 - start_iter
        for (image, label), w in zip(got, want):
            np.testing.assert_array_equal(image.transpose(0, 2, 3, 1), w["image"])
            np.testing.assert_array_equal(label, w["label"])


# ------------------------------------------------------------- the layout

@pytest.mark.parametrize("axis", ["MODEL", "SPATIAL"])
@pytest.mark.parametrize("cli", ["train", "val"])
def test_tensor_and_spatial_parallelism_are_refused(axis, cli, tmp_path):
    # neither a MODEL nor a SPATIAL of 2 divides one process
    main = train_main if cli == "train" else val_main
    with pytest.raises(ValueError, match=f"PARALLEL.{axis} 2"):
        main(["--config", str(SMOKE), "--device", "cpu", "SAVE_DIR", str(tmp_path),
              f"PARALLEL.{axis}", "2"])


def test_a_data_axis_other_than_the_world_is_refused():
    cfg = get_config(str(SMOKE))
    check_parallel(cfg, 1)                      # -1: every rank
    cfg.PARALLEL.DATA = 1
    check_parallel(cfg, 1)
    cfg.PARALLEL.DATA = 2
    with pytest.raises(ValueError, match="PARALLEL.DATA 2"):
        check_parallel(cfg, 1)
    check_parallel(cfg, 2)


# (WORLD_SIZE, LOCAL_WORLD_SIZE, cards, --device) -> (device, backend); rank 1
JOIN = {
    ("2", "2", 4, "cuda"): ("cuda:1", "nccl"),       # a card a rank
    ("2", "2", 1, "cuda"): ("cuda:0", "gloo"),       # two ranks share the card
    ("4", "2", 2, "cuda"): ("cuda:1", "nccl"),       # two machines of two cards
    ("2", "2", 4, "cuda:2"): ("cuda:2", "nccl"),     # an index stays
    ("2", "2", 0, "cpu"): ("cpu", "gloo"),
    (None, None, 4, "cuda"): ("cuda", None),         # no torchrun: no group
    ("1", "1", 4, "cpu"): ("cpu", None),
}


@pytest.mark.parametrize("key", list(JOIN))
def test_distributed_joins_torchruns_group_with_the_device_and_backend(key, monkeypatch):
    """``distributed`` under torchrun's environment (init_process_group and
    the CUDA calls stubbed): the device of rank 1, the backend it joins
    with, and the group torn down at the end of the block."""
    import torch.distributed as dist

    from emrt_tpu_torch.parallel import distributed
    world, local_world, cards, device = key
    for name, value in (("WORLD_SIZE", world), ("LOCAL_WORLD_SIZE", local_world)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda backend: calls.append(backend))
    monkeypatch.setattr(dist, "destroy_process_group", lambda: calls.append("destroyed"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(str(d)))
    want_device, want_backend = JOIN[key]
    with distributed(device) as got:
        assert str(got) == want_device
        joined = [c for c in calls if c != "destroyed"]
        assert joined == ([] if want_backend is None else
                          [want_device, want_backend] if got.type == "cuda" else [want_backend])
    assert calls.count("destroyed") == (want_backend is not None)
    assert not dist.is_initialized()


def test_step_seed_folds_in_the_rank_only_under_data_parallelism():
    assert step_seed(0, 5) == step_seed(0, 5, 0, 1)
    seeds = {step_seed(0, 5, r, 2) for r in range(2)}
    assert len(seeds) == 2
    assert step_seed(0, 5, 1, 2) == step_seed(0, 5, 1, 2)


# ------------------------------------------------------ DDP's unused parameters

CONFIGS = Path(SMOKE).parents[1]
# yaml -> the parameters a train step leaves without a gradient
UNUSED = {
    "EMRT/EMRT_256x256_160k_potsdam.yaml": 0,
    "EMRT/EMRT_256x256_160k_potsdam_hrnet.yaml": 0,
    "EMRT/EMRT_256x256_160k_potsdam_segformer.yaml": 0,
    "EMRT/EMRT_256x256_160k_potsdam_cswin.yaml": 2,       # layer_norms.0 (the first tap)
    "EMRT/EMRT_256x256_160k_potsdam_vit.yaml": 2,
    "trans2seg/Trans2Seg_medium_256x256_160k_potsdam.yaml": 32,
    "setr/SETR_PUP_Large_256x256_160k_potsdam_bs_8.yaml": 0,
    "upernet_swin/upernet_swin_tiny_patch4_windown7_512x512_160k_potsdam.yaml": 0,
    "dpt/DPT_Large_512x512_160k_potsdam_bs_8.yaml": 0,
    "segformer/segformer_b0_512x512_160k_ade20k.yaml": 0,
    "segmenter/segmenter_base_distilled_512x512_160k_ade20k_bs_16.yaml": 0,
}


@pytest.mark.parametrize("yaml", list(UNUSED))
def test_ddp_looks_for_unused_parameters_where_a_model_leaves_some(yaml, monkeypatch):
    autocast = torch.autocast
    monkeypatch.setattr(torch, "autocast", lambda device, *a, **k: contextlib.nullcontext()
                        if device == "meta" else autocast(device, *a, **k))
    cfg = get_config(str(CONFIGS / yaml))
    cfg.TRAIN.DTYPE = "float32"
    with torch.device("meta"):
        model = get_model(cfg, use_kernel=False)
    h, w = cfg.DATA.CROP_SIZE
    out = model.train()(torch.empty((2, 3, h, w), device="meta"))
    get_loss_function(cfg)(list(out), torch.empty((2, h, w), dtype=torch.long,
                                                  device="meta")).backward()
    unused = [n for n, p in model.named_parameters() if p.grad is None]
    assert len(unused) == UNUSED[yaml], unused
    assert getattr(model, "ddp_find_unused_parameters", False) == bool(unused)
