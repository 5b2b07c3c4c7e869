"""The rank-side halves of the data-parallel tests (``test_torch_parallel.py``,
``test_torch_parallel_train.py``, ``test_torch_parallel_eval.py``).

Each function runs on every rank of ``emrt_tpu_torch.parallel.launch.run_ranks``:
a spawned child that imports this module, so the module imports neither JAX
nor the JAX package and the children start quickly. Inputs come in as numpy
arrays made by the tests from seeds, results go back as numpy arrays and
Python values. Rank r holds rows ``rows(n, r, world)`` of a global batch of
n: the ranks' rows in rank order make the global batch, as the JAX package's
``data`` axis shards it. The module holds no tests.
"""
from __future__ import annotations

import importlib
from pathlib import Path

import numpy as np
import torch

from emrt_tpu_torch import config as torch_config
from emrt_tpu_torch.parallel import SyncBatchNorm1d, SyncBatchNorm2d, world_size

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "EMRT" / "EMRT_smoke_synthetic.yaml"
FLAGSHIP = ROOT / "configs" / "EMRT" / "EMRT_256x256_160k_potsdam.yaml"
NUM_CLASSES = 6


def rows(n: int, rank: int, world: int) -> slice:
    per = n // world
    return slice(rank * per, (rank + 1) * per)


# -------------------------------------------------------------- SyncBatchNorm

def sync_bn_rank(rank, world, x, grad_y, weight, bias):
    """This rank's rows of ``x`` through a SyncBatchNorm (2-d for [n, c, h, w],
    1-d for [n, c]) in training mode, backward from ``grad_y``'s rows.
    Returns the output rows, the input gradient rows, this rank's affine
    gradients, the running statistics and the step counter."""
    cls = SyncBatchNorm2d if x.ndim == 4 else SyncBatchNorm1d
    bn = cls(x.shape[1], eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    part = rows(len(x), rank, world)
    xr = torch.from_numpy(x[part]).requires_grad_(True)
    y = bn.train()(xr)
    y.backward(torch.from_numpy(grad_y[part]))
    return {"y": y.detach().numpy(), "grad_x": xr.grad.numpy(),
            "grad_weight": bn.weight.grad.numpy(), "grad_bias": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(), "running_var": bn.running_var.numpy(),
            "num_batches_tracked": int(bn.num_batches_tracked)}


# ---------------------------------------------------------------------- losses

def make_loss(name):
    from emrt_tpu_torch.losses import (CrossEntropyLoss, MixSoftmaxCrossEntropyLoss,
                                       MultiCrossEntropyLoss, OhemCrossEntropyLoss)
    return {"CE": lambda: CrossEntropyLoss(255),
            "MixSoftmax": lambda: MixSoftmaxCrossEntropyLoss(255, aux=True, aux_weight=0.4),
            "MultiCE": lambda: MultiCrossEntropyLoss(255, weights=(1, 0.4, 0.4)),
            "OHEM": lambda: OhemCrossEntropyLoss(255, thresh=0.3, min_kept=40)}[name]()


def losses_rank(rank, world, cases):
    """For each (key, loss name, global NCHW logits list, global labels) of
    ``cases``: this rank's loss on its rows, the mean of the ranks' losses
    (what the train step reports) and the gradients of this rank's logits."""
    from emrt_tpu_torch.parallel.mesh import all_reduce_sum
    out = {}
    for key, name, logits, label in cases:
        part = rows(len(label), rank, world)
        ts = [torch.from_numpy(a[part]).requires_grad_(True) for a in logits]
        loss = make_loss(name)(ts, torch.from_numpy(label[part]).long())
        loss.backward()
        reported = all_reduce_sum(loss.detach().clone()) / world_size()
        out[key] = {"loss": loss.item(), "reported": reported.item(),
                    "grads": [t.grad.numpy() for t in ts]}
    return out


# ---------------------------------------------------------------------- loader

def loader_rank(rank, world, batch_size, iters, seed, start_iter):
    """The train CLI's loader on this rank (``make_train_loader``) over 10
    synthetic samples of 16^2: its batches as numpy."""
    from emrt_tpu_torch.data import SyntheticDataset
    from emrt_tpu_torch.data.transforms import get_transforms
    from emrt_tpu_torch.train.cli import make_train_loader
    cfg = torch_config.get_config(str(SMOKE))
    cfg.DATA.CROP_SIZE = (16, 16)
    cfg.DATA.BATCH_SIZE, cfg.TRAIN.ITERS, cfg.SEED = batch_size, iters, seed
    cfg.DATA.NUM_WORKERS = 3
    ds = SyntheticDataset(get_transforms(cfg), num_samples=10, crop_size=(16, 16))
    loader = make_train_loader(cfg, ds, None)
    loader.start_iter = start_iter
    return [(b["image"].numpy(), b["label"].numpy()) for b in loader]


# ------------------------------------------------------------------ train step

def train_step_rank(rank, world, state_path, image, label):
    """One step of the tiny EMRT-R50 (1 encoder and 1 decoder layer, dropout
    0, float32) from the bridged weights at ``state_path``, with the flagship
    config's solver and loss, data-parallel as the train CLI runs it
    (SyncBatchNorm, DDP). Returns the loss as the train CLI logs it (the
    ranks' mean), the step count and the model's state dict."""
    from torch.nn.parallel import DistributedDataParallel

    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.models.emrt import EMRT
    from emrt_tpu_torch.parallel import convert_sync_batchnorm
    from emrt_tpu_torch.parallel.mesh import all_reduce_sum
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import make_train_step
    model = EMRT(num_classes=NUM_CLASSES, num_encoder_layers=1, num_decoder_layers=1)
    missing, unexpected = model.load_state_dict(torch.load(state_path, weights_only=True),
                                                strict=False)
    assert unexpected == [] and all(k.endswith("num_batches_tracked") for k in missing)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    convert_sync_batchnorm(model)
    cfg = torch_config.get_config(str(FLAGSHIP))
    optimizer = get_optimizer(cfg, model, get_scheduler(cfg))
    ddp = DistributedDataParallel(model, broadcast_buffers=False)
    step = make_train_step(ddp, get_loss_function(cfg), optimizer)
    part = rows(len(label), rank, world)
    loss = step({"image": torch.from_numpy(image[part].transpose(0, 3, 1, 2).copy()),
                 "label": torch.from_numpy(label[part]).long()})
    loss = all_reduce_sum(loss.clone()) / world
    return {"loss": loss.item(), "steps": optimizer.step_count,
            "state": {k: v.numpy() for k, v in model.state_dict().items()}}


# --------------------------------------------------------------- the train CLI

def train_main_rank(rank, world, argv, resume_argv):
    """``train.main(argv)`` and then ``train.main(resume_argv)`` on this rank;
    returns both summaries and the files this rank wrote (the checkpoint
    module's ``_save`` calls)."""
    from emrt_tpu_torch.train import main as train_main
    from emrt_tpu_torch.utils import checkpoint
    written = []
    save = checkpoint._save

    def counting_save(obj, path):
        written.append(Path(path).name)
        save(obj, path)

    checkpoint._save = counting_save
    first = train_main(argv)
    second = train_main(resume_argv)
    return {"first": first, "second": second, "written": written}


# -------------------------------------------------------------------- evaluate

LINEAR = np.random.default_rng(5).normal(size=(NUM_CLASSES, 3)).astype(np.float32)


def linear_forward(x):
    """A pointwise model: logits = LINEAR @ the pixel's three channels."""
    return torch.einsum("ck,nkhw->nchw", torch.from_numpy(LINEAR), x)


class ValDataset:
    """Seeded normalized images and labels of the given shapes."""

    def __init__(self, shapes, seed):
        rng = np.random.default_rng(seed)
        self.items = [(rng.standard_normal((h, w, 3)).astype(np.float32),
                       rng.integers(0, NUM_CLASSES, (h, w)).astype(np.int32))
                      for h, w in shapes]

    def __len__(self):
        return len(self.items)

    def get(self, i, rng=None):
        return self.items[i]


def val_config(mod, scales):
    cfg = mod.get_config()
    cfg.DATA.NUM_CLASSES = NUM_CLASSES
    cfg.DATA.BATCH_SIZE_VAL = 2
    cfg.VAL.CROP_SIZE = [64, 64]
    cfg.VAL.STRIDE_SIZE = [43, 43]
    if scales:
        cfg.VAL.SCALE_RATIOS = list(scales)
    return cfg


def evaluate_rank(rank, world, shapes, scales):
    """``evaluate`` of ``linear_forward`` over ``ValDataset(shapes)`` (with
    TTA over ``scales`` when given) on this rank. Returns the summary, the
    images this rank predicted, the confusion matrices of its batches and
    the confusion areas the metrics were computed from."""
    ev = importlib.import_module("emrt_tpu_torch.inference.evaluate")
    cms, areas, seen = [], [], []
    confusion_matrix, accumulator = ev.confusion_matrix, ev.MetricAccumulator

    class Spy(accumulator):
        def update_areas(self, intersect, pred, label):
            areas.append([np.asarray(a).tolist() for a in (intersect, pred, label)])
            super().update_areas(intersect, pred, label)

    def spy_cm(pred, label, *args):
        cm = confusion_matrix(pred, label, *args)
        cms.append(cm.numpy())
        return cm

    def forward(x):
        seen.append(x.shape)
        return linear_forward(x)

    ev.confusion_matrix, ev.MetricAccumulator = spy_cm, Spy
    try:
        with torch.no_grad():
            result = ev.evaluate(forward, ValDataset(shapes, seed=9),
                                 val_config(torch_config, scales), "cpu",
                                 multi_scales=bool(scales), window_batch=2, progbar=False)
    finally:
        ev.confusion_matrix, ev.MetricAccumulator = confusion_matrix, accumulator
    result.pop("val_time")
    return {"result": result, "cms": cms, "areas": areas, "forwards": len(seen)}
