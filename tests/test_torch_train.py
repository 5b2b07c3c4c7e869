"""The port's training pieces against the JAX package's, on the same numpy
inputs: the losses (with an all-ignored batch, fault F4), the polynomial
schedule, five SGD steps against the optax chain, the sampler and loader
batches, BatchNorm's running statistics (F2) and the dropout kind (F3), the
timers and checkpoints, and the ``train`` CLI on the smoke config. The whole
train step of the tiny EMRT is in ``test_torch_train_step.py``.

Bounds: float32 reductions taken in another order, 1e-6 relative (losses,
BatchNorm statistics, schedule, SGD); data, indices and counts exactly.
"""
from __future__ import annotations

import json
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
from emrt_tpu.data.loader import IterationSampler as JaxSampler  # noqa: E402
from emrt_tpu.data.transforms import get_transforms as jax_transforms  # noqa: E402
from emrt_tpu.losses import CrossEntropyLoss as JaxCE  # noqa: E402
from emrt_tpu.losses import MixSoftmaxCrossEntropyLoss as JaxMix  # noqa: E402
from emrt_tpu.solver import get_optimizer as jax_optimizer  # noqa: E402
from emrt_tpu.solver.lr_scheduler import polynomial_decay as jax_poly  # noqa: E402
from emrt_tpu.utils.timer import TimeAverager as JaxTimeAverager  # noqa: E402
from emrt_tpu.utils.timer import calculate_eta as jax_eta  # noqa: E402

from emrt_tpu_torch import config as torch_config  # noqa: E402
from emrt_tpu_torch.data import DataLoader, IterationSampler, SyntheticDataset  # noqa: E402
from emrt_tpu_torch.data.transforms import get_transforms  # noqa: E402
from emrt_tpu_torch.losses import (CrossEntropyLoss, MixSoftmaxCrossEntropyLoss,  # noqa: E402
                                   get_loss_function)
from emrt_tpu_torch.models.emrt import EMRT  # noqa: E402
from emrt_tpu_torch.models.layers import BatchNorm2d, ConvBNReLU  # noqa: E402
from emrt_tpu_torch.solver import SGD, get_optimizer, get_scheduler, polynomial_decay  # noqa: E402
from emrt_tpu_torch.train import main as train_main  # noqa: E402
from emrt_tpu_torch.utils import TimeAverager, calculate_eta  # noqa: E402
from emrt_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "EMRT" / "EMRT_smoke_synthetic.yaml"
FLAGSHIP = ROOT / "configs" / "EMRT" / "EMRT_256x256_160k_potsdam.yaml"


# ---------------------------------------------------------------- losses (F4)

def _logits_labels(ignored: float, seed=0, n=2, c=6, h=9, w=7):
    rng = np.random.default_rng(seed)
    main = rng.normal(size=(n, c, h, w)).astype(np.float32) * 3
    aux = rng.normal(size=(n, c, h, w)).astype(np.float32) * 3
    label = rng.integers(0, c, (n, h, w))
    label = np.where(rng.random((n, h, w)) < ignored, 255, label).astype(np.int32)
    return main, aux, label


@pytest.mark.parametrize("ignored", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("which", ["CE", "MixSoftmax"])
def test_losses_match_jax(which, ignored):
    """NCHW logits here, NHWC there; an all-ignored batch gives 0 in both."""
    main, aux, label = _logits_labels(ignored)
    nhwc = [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in (main, aux)]
    if which == "CE":
        want = JaxCE(255)(nhwc, jnp.asarray(label))
        got = CrossEntropyLoss(255)([torch.from_numpy(main), torch.from_numpy(aux)],
                                    torch.from_numpy(label))
    else:
        want = JaxMix(255, aux=True, aux_weight=0.4)(nhwc, jnp.asarray(label))
        got = MixSoftmaxCrossEntropyLoss(255, aux=True, aux_weight=0.4)(
            [torch.from_numpy(main), torch.from_numpy(aux)], torch.from_numpy(label))
    assert got.dtype == torch.float32 and torch.isfinite(got)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    if ignored == 1.0:
        assert got.item() == 0.0


def test_loss_gradient_flows_only_through_kept_pixels():
    main, _, label = _logits_labels(0.5)
    logits = torch.from_numpy(main).requires_grad_()
    CrossEntropyLoss(255)(logits, torch.from_numpy(label)).backward()
    ignored = torch.from_numpy(label == 255)
    assert not logits.grad.permute(0, 2, 3, 1)[ignored].any()
    assert logits.grad.permute(0, 2, 3, 1)[~ignored].abs().sum() > 0


@pytest.mark.parametrize("what, key, value", [
    ("loss", "TRAIN.LOSS", "OhemCrossEntropyLoss"),
    ("loss", "TRAIN.LOSS", "MultiCrossEntropyLoss"),
    ("scheduler", "TRAIN.LR_SCHEDULER.NAME", "WarmupPolyLR"),
    ("scheduler", "TRAIN.LR_SCHEDULER.NAME", "WarmupCosineLR"),
    ("optimizer", "TRAIN.OPTIMIZER.NAME", "Adadelta"),
    ("optimizer", "TRAIN.OPTIMIZER.NAME", "RMSProp"),
])
def test_what_is_not_ported_raises(what, key, value):
    cfg = torch_config.get_config(str(FLAGSHIP))
    cfg.merge_from_list([key, value])
    build = {"loss": lambda: get_loss_function(cfg),
             "scheduler": lambda: get_scheduler(cfg),
             "optimizer": lambda: get_optimizer(cfg, torch.nn.Linear(2, 2),
                                                lambda s: 0.1)}[what]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build()


# ---------------------------------------------------------- schedule, solver

def test_polynomial_decay_matches_jax():
    """To 1e-6 of the base lr: the JAX schedule runs in float32, this one in
    Python floats (near the end, 1 - step/160000 keeps few float32 digits)."""
    cfg = torch_config.get_config(str(FLAGSHIP))
    schedule = get_scheduler(cfg)
    want = jax_poly(0.01, 160000, 0.0, 0.9)
    for step in (0, 1, 17, 80000, 159999, 160000, 170000):
        np.testing.assert_allclose(schedule(step), float(want(jnp.asarray(step))),
                                   rtol=1e-6, atol=1e-8)
    short = polynomial_decay(0.1, 10, 1e-3, 2.0)
    np.testing.assert_allclose([short(s) for s in range(12)],
                               [float(jax_poly(0.1, 10, 1e-3, 2.0)(jnp.asarray(s)))
                                for s in range(12)], rtol=1e-6)


_PARAM_SHAPES = {"encoder/self_attn/sampling_offsets/kernel": (4, 6),
                 "encoder/self_attn/value_proj/kernel": (4, 4),
                 "reference_points/bias": (2,),
                 "head/bias": (3,)}


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_matches_the_optax_chain(nesterov):
    """Five steps on the same gradients: clip by global norm 1.0 (the first
    steps' norms are above it, the later ones below), weight decay 1e-4,
    momentum 0.9, the poly lr and x0.1 on the deformable offsets and
    reference points."""
    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in _PARAM_SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32)
              for k, s in _PARAM_SHAPES.items()} for scale in (3.0, 1.0, 0.3, 0.1, 0.05)]
    cfg = jax_config.get_config(str(FLAGSHIP))
    cfg.TRAIN.OPTIMIZER.NESTEROV = nesterov
    cfg.TRAIN.ITERS = 8

    def tree(flat):
        out = {}
        for k, v in flat.items():
            node = out
            *parents, leaf = k.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
        return out

    def flat(t, prefix=""):
        return {k2: v2 for k, v in t.items()
                for k2, v2 in (flat(v, f"{prefix}{k}/").items() if isinstance(v, dict)
                               else [(f"{prefix}{k}", np.asarray(v))])}

    schedule = polynomial_decay(0.01, 8, 0.0, 0.9)
    tx = jax_optimizer(cfg, jax_poly(0.01, 8, 0.0, 0.9), params=tree(init))
    params = tree(init)
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(tree(g), opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
    want = flat(params)

    named = [(k.replace("/", "."), torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, v in init.items()]
    opt = SGD(named, schedule, momentum=0.9, nesterov=nesterov, weight_decay=1e-4,
              grad_clip=1.0)
    assert [len(g["params"]) for g in opt.optimizer.param_groups] == [2, 2]
    for g in grads:
        for name, p in named:
            p.grad = torch.from_numpy(g[name.replace(".", "/")].copy())
        opt.step()
    assert opt.step_count == 5
    for name, p in named:
        np.testing.assert_allclose(p.detach().numpy(), want[name.replace(".", "/")],
                                   rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------- data

@pytest.mark.parametrize("seed, shard, shards, shuffle", [
    (0, 0, 1, True), (3, 1, 2, True), (5, 2, 3, False), (7, 0, 4, True)])
def test_iteration_sampler_matches_jax(seed, shard, shards, shuffle):
    got = IterationSampler(21, 4, shuffle=shuffle, seed=seed, shard_index=shard,
                           num_shards=shards)
    want = JaxSampler(21, 4, shuffle=shuffle, seed=seed, shard_index=shard,
                      num_shards=shards)
    for a, b, _ in zip(iter(got), iter(want), range(17)):      # past three epochs
        np.testing.assert_array_equal(a, b)


def _synthetic_config():
    cfg = torch_config.get_config(str(SMOKE))
    cfg.DATA.CROP_SIZE = (16, 16)
    return cfg


@pytest.mark.parametrize("start_iter, shard, shards", [(0, 0, 1), (3, 1, 2)])
def test_loader_batches_equal_the_jax_loader(start_iter, shard, shards):
    """Flip augmentation drawn from the per-sample generators: the same
    batches bit for bit, NCHW float32 and int64 labels here."""
    cfg = _synthetic_config()
    jcfg = jax_config.get_config(str(SMOKE))
    jcfg.DATA.CROP_SIZE = (16, 16)
    ds = SyntheticDataset(get_transforms(cfg), num_samples=10, crop_size=(16, 16))
    jds = JaxSynthetic(jax_transforms(jcfg), num_samples=10, crop_size=(16, 16))
    kw = dict(iterations=7, seed=11, num_workers=3, start_iter=start_iter,
              shard_index=shard, num_shards=shards)
    got = list(DataLoader(ds, 2, **kw))
    want = list(JaxDataLoader(jds, 2, **kw))
    assert len(got) == len(want) == 7 - start_iter
    for g, w in zip(got, want):
        assert g["image"].dtype == torch.float32 and g["label"].dtype == torch.int64
        np.testing.assert_array_equal(g["image"].numpy().transpose(0, 2, 3, 1), w["image"])
        np.testing.assert_array_equal(g["label"].numpy(), w["label"])


def test_loader_raises_what_a_worker_raised():
    class Broken(SyntheticDataset):
        def get(self, idx, rng=None):
            raise OSError("unreadable tile")

    ds = Broken([], num_samples=4, crop_size=(8, 8))
    with pytest.raises(OSError, match="unreadable tile"):
        list(DataLoader(ds, 2, iterations=3))


# ---------------------------------------------------- BatchNorm (F2), dropout (F3)

@pytest.mark.parametrize("shape", [(2, 8, 5, 5), (2, 8, 1, 1), (8, 8, 1, 1)])
def test_batchnorm_running_stats_match_flax(shape):
    """One train-mode forward from non-trivial running statistics: both
    statistics as flax's BatchNorm (momentum 0.9, biased variance) to 1e-6,
    the 1x1 maps of the PSP branches included (n = batch). The outputs agree
    to 2e-4: flax takes the batch variance in one pass, E[x^2] - E[x]^2,
    which loses digits where a channel's two values nearly agree."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    mean0 = rng.normal(size=shape[1]).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, shape[1]).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, shape[1]).astype(np.float32)
    beta = rng.normal(size=shape[1]).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": gamma, "bias": beta},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, new = bn.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
                         mutable=["batch_stats"])
    mod = BatchNorm2d(shape[1], eps=1e-5).train()
    with torch.no_grad():
        for t, v in ((mod.running_mean, mean0), (mod.running_var, var0),
                     (mod.weight, gamma), (mod.bias, beta)):
            t.copy_(torch.from_numpy(v))
    got = mod(torch.from_numpy(x).requires_grad_())
    got.sum().backward()                       # autograd still works after the fix
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(mod.running_mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]), rtol=1e-6)
    np.testing.assert_allclose(mod.running_var.numpy(),
                               np.asarray(new["batch_stats"]["var"]), rtol=1e-6)
    assert int(mod.num_batches_tracked) == 1


def test_every_batchnorm_of_emrt_follows_flax():
    model = EMRT(num_classes=6, backbone="resnet18", num_encoder_layers=1,
                 num_decoder_layers=1)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    assert len(bns) > 30 and all(type(m) is BatchNorm2d for m in bns)
    assert isinstance(ConvBNReLU(4, 4)[1], BatchNorm2d)


@pytest.mark.parametrize("site", ["cls_psp", "auxlayer"])
def test_dropout_is_elementwise(site):
    """As flax's nn.Dropout(0.1): about 10% of the elements of each channel
    are zeroed, not whole channels (nn.Dropout2d)."""
    model = EMRT(num_classes=6, backbone="resnet18", num_encoder_layers=1,
                 num_decoder_layers=1).train()
    drop = model.cls_psp[-1] if site == "cls_psp" else model.auxlayer.dropout
    torch.manual_seed(0)
    out = drop(torch.ones((4, 64, 16, 16)))
    zero = (out == 0).float().mean(dim=(2, 3))              # per (image, channel)
    assert abs(zero.mean().item() - 0.1) < 0.01
    assert ((zero > 0) & (zero < 1)).float().mean().item() > 0.95
    kept = out[out != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.9))


def test_training_after_an_inference_mode_eval():
    """The per-geometry tables are cached on first use; an eval under
    torch.inference_mode that comes first must not leave inference tensors
    for the backward of a later train step."""
    from emrt_tpu_torch.models import deformable_transformer
    deformable_transformer._level_tables.cache_clear()
    model = EMRT(num_classes=6, backbone="resnet18", num_encoder_layers=1,
                 num_decoder_layers=1)
    x = torch.randn((2, 3, 64, 64))
    with torch.inference_mode():
        model.eval()(x)
    main, aux = model.train()(x)
    (main.mean() + aux.mean()).backward()
    grad = model.model.encoder.layers[0].self_attn.sampling_offsets.weight.grad
    assert grad is not None and torch.isfinite(grad).all()


# ------------------------------------------------------ timers, checkpoints

@pytest.mark.parametrize("remaining, speed", [(0, 1.0), (-3, 2.0), (100, 0.37),
                                              (160000, 0.25), (10 ** 6, 13.3)])
def test_eta_matches_jax(remaining, speed):
    assert calculate_eta(remaining, speed) == jax_eta(remaining, speed)


def test_time_averager_matches_jax():
    got, want = TimeAverager(), JaxTimeAverager()
    for t, n in ((0.5, 8), (0.25, 8), (0.75, None)):
        got.record(t, n)
        want.record(t, n)
    assert got.get_average() == want.get_average()
    assert got.get_ips_average() == want.get_ips_average()


def test_checkpoints_rotate_restore_and_keep_the_best(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = SGD(model.named_parameters(), lambda s: 0.1, momentum=0.9)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (2, 4, 6):
        model(torch.ones(1, 3)).sum().backward()
        opt.step()
        mgr.save(step, model, opt)
    assert mgr.steps() == [4, 6]
    assert mgr.save_best(model, 0.5) and not mgr.save_best(model, 0.4)
    assert json.loads((tmp_path / "best_model.json").read_text()) == {"best_miou": 0.5}
    assert CheckpointManager(str(tmp_path)).best_miou == 0.5

    fresh = torch.nn.Linear(3, 2)
    fresh_opt = SGD(fresh.named_parameters(), lambda s: 0.1, momentum=0.9)
    assert mgr.restore(fresh, fresh_opt) == 6 and fresh_opt.step_count == 3
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)
    buf = fresh_opt.optimizer.state[next(iter(fresh.parameters()))]["momentum_buffer"]
    assert buf.abs().sum() > 0
    assert CheckpointManager(str(tmp_path / "empty")).restore(fresh, fresh_opt) == 0


# ------------------------------------------------------------------- CLI

def test_train_cli_saves_evaluates_and_resumes(tmp_path):
    """The smoke config on the CPU (resnet18, 32^2 crops to keep it short):
    two iterations with a save and an eval each, then --resume runs the
    third from the saved step."""
    common = ["--config", str(SMOKE), "--device", "cpu", "SAVE_DIR", str(tmp_path),
              "TRAIN.DTYPE", "float32", "MODEL.ENCODER.TYPE", "resnet18",
              "DATA.CROP_SIZE", "(32, 32)", "VAL.IMAGE_BASE_SIZE", "32",
              "VAL.CROP_SIZE", "(32, 32)", "VAL.STRIDE_SIZE", "(32, 32)",
              "DATA.BATCH_SIZE_VAL", "16", "LOGGING_INFO_FREQ", "1",
              "SAVE_FREQ_CHECKPOINT", "1", "VALIDATE_FREQ", "2",
              "KEEP_CHECKPOINT_MAX", "1"]
    first = train_main(["--iters", "2", *common])
    assert (first["start_iter"], first["last_iter"], first["steps"]) == (0, 2, 2)
    assert len(first["losses"]) == 2 and all(np.isfinite(first["losses"]))
    assert len(first["mious"]) == 1 and 0.0 <= first["mious"][0] <= 1.0
    assert first["eval_forwards"] == 64 // 16
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == ["iter_2.pt"]
    assert (tmp_path / "best_model.pt").exists()
    assert (tmp_path / "best_model.json").exists()

    second = train_main(["--iters", "3", "--resume", *common])
    assert (second["start_iter"], second["last_iter"], second["steps"]) == (2, 3, 1)
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == ["iter_3.pt"]
    state = torch.load(tmp_path / "checkpoints" / "iter_3.pt", weights_only=True)
    assert state["step"] == 3 and state["optimizer"]["step_count"] == 3


def test_a_resumed_run_draws_the_dropout_masks_of_an_uninterrupted_one(tmp_path):
    """F7: CPU, float32, dropout on. Three iterations, and a run resumed at
    the third from the same run's step-2 checkpoint, end with the same
    weights, bit for bit: each step seeds torch from (SEED, step)."""
    common = ["--config", str(SMOKE), "--device", "cpu", "--iters", "3",
              "TRAIN.DTYPE", "float32", "MODEL.ENCODER.TYPE", "resnet18",
              "DATA.CROP_SIZE", "(32, 32)", "VAL.IMAGE_BASE_SIZE", "32",
              "VAL.CROP_SIZE", "(32, 32)", "VAL.STRIDE_SIZE", "(32, 32)",
              "DATA.BATCH_SIZE_VAL", "32", "SAVE_FREQ_CHECKPOINT", "1",
              "KEEP_CHECKPOINT_MAX", "3"]
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    train_main([*common, "SAVE_DIR", str(straight)])
    (resumed / "checkpoints").mkdir(parents=True)
    (resumed / "checkpoints" / "iter_2.pt").write_bytes(
        (straight / "checkpoints" / "iter_2.pt").read_bytes())
    out = train_main(["--resume", *common, "SAVE_DIR", str(resumed)])
    assert (out["start_iter"], out["steps"]) == (2, 1)
    model = EMRT(num_classes=6, backbone="resnet18")
    assert any(isinstance(m, torch.nn.Dropout) and m.p > 0 for m in model.modules())
    a, b = (torch.load(d / "checkpoints" / "iter_3.pt", weights_only=True)["model"]
            for d in (straight, resumed))
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_train_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--config", str(SMOKE), "--device", "cuda"])
