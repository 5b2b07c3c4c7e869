"""Training CLI of the port (counterpart of the repo's ``train.py``; reference
contract: semantic_segmentation/train.py).

Usage: python3 -m emrt_tpu_torch.train --config <yaml> [--iters N] [--seed S]
       [--resume] [--device cuda|cpu] [KEY VALUE ...]
       torchrun --nproc_per_node N -m emrt_tpu_torch.train --config <yaml> ...

Eager PyTorch: the train step of ``train/step.py`` over the threaded loader,
windowed loss / lr / batch-cost / ips / ETA logging every LOGGING_INFO_FREQ
iterations, a checkpoint every SAVE_FREQ_CHECKPOINT (newest
KEEP_CHECKPOINT_MAX kept), and sliding-window ``evaluate`` every
VALIDATE_FREQ with the best mIoU's model saved; all three also at the last
iteration. Each step seeds torch from (SEED, step), so dropout draws the
same masks whether or not the run was resumed; ``--resume`` continues from
the latest checkpoint in SAVE_DIR, with the loader skipping the batches
already consumed. MODEL.PRETRAINED takes a ``.pt`` file of this package or a
reference ``.pdparams`` (a whole model, or a prefix-less ImageNet ResNet for
the backbone). The model's FLOPs and parameters are reported at the end.

Under ``torchrun`` (WORLD_SIZE > 1) it trains over the JAX package's
``(data, model)`` mesh (``train.py:55-152``): one process a GPU
(``--device cuda`` is ``cuda:LOCAL_RANK``), the ranks laid out as
PARALLEL.DATA x PARALLEL.MODEL (``parallel.mesh.model_parallel``). With
PARALLEL.MODEL = T > 1 the transformer's projections are split Megatron-style
over each model group of T ranks (``parallel.tensor.split_model_``: the
deformable attention and the decoder's self-attention by heads, the FFNs by
hidden units), as ``tp_shard_params`` places them. Each data group trains
data-parallel: DATA.BATCH_SIZE rows a rank from the loader's shard of its
data rank (the ranks of a model group load the same rows), BatchNorm over
the data group's global batch (``parallel.convert_sync_batchnorm``), DDP's
gradients averaged over the data group, the losses' global mean; the seed
of a step folds in the data rank. Evaluation is sharded over the data
ranks, rank 0 logs, writes the checkpoints (whole tensors, gathered over
the model group) and counts the FLOPs and parameters of the whole model.
Tensor parallelism: ``torchrun --nproc_per_node 4 -m emrt_tpu_torch.train
--config <yaml> PARALLEL.MODEL 2`` (dp2 x tp2).

With PARALLEL.SPATIAL = S > 1 (an EMRT with any backbone: ResNet,
ResNeXt, ResNeSt, HRNet, CSwin, ViT or SegFormer-B4; not the zoo;
``parallel.check_parallel``) the ranks are laid out as DATA x MODEL x S, as
the JAX package places the batch on ``spatial_batch_sharding``: the S ranks
of a spatial group load their data rank's rows and each trains on its block
of H / S image and label rows (``parallel.spatial.shard_model_``: halo
exchanges in the sharded region, the keys and values of a transformer
backbone's attentions gathered for the rank's queries, ViT's cls token on
spatial rank 0 alone, the maps gathered for the deformable transformer).
DDP, the sharded region's
BatchNorm and the losses' count (OHEM's k-th probability too) run over the
gradient group (data x spatial of equal model rank), the logged loss is
that group's mean, and evaluation runs the whole model, sharded over the
data ranks only: ``torchrun --nproc_per_node 2 -m emrt_tpu_torch.train
--config <yaml> PARALLEL.SPATIAL 2`` (dp1 x sp2). Both compose: the model is
split, then sharded, and ``GradientSync`` works over the model group after
DDP's sum over the gradient group: ``torchrun --nproc_per_node 4 -m
emrt_tpu_torch.train --config configs/EMRT/EMRT_256x256_160k_potsdam.yaml
PARALLEL.MODEL 2 PARALLEL.SPATIAL 2`` (dp1 x tp2 x sp2).
"""
from __future__ import annotations

import argparse
import random

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from ..config import get_config, update_config
from ..data import DataLoader, get_dataset, get_transforms
from ..inference import build_val_transforms, evaluate
from ..losses import get_loss_function
from ..models import get_model
from ..parallel import (check_parallel, convert_sync_batchnorm, distributed, is_main,
                        world_size)
from ..parallel.mesh import (all_reduce_gradient, build_kernels_once, data_rank, data_world,
                             gradient_group, gradient_world, model_parallel)
from ..parallel.spatial import shard_for_the_group
from ..parallel.tensor import split_for_the_group
from ..solver import get_optimizer, get_scheduler
from ..utils import TimeAverager, Timer, calculate_eta, logger
from ..utils.checkpoint import CheckpointManager, load_weights_auto
from ..utils.flops import format_cost, forward_cost
from .step import make_train_step


def parse_args(argv=None):
    parser = argparse.ArgumentParser("EMRT training (PyTorch port)")
    parser.add_argument("--config", dest="cfg", type=str, required=True)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in SAVE_DIR")
    parser.add_argument("--iters", type=int, default=None,
                        help="override TRAIN.ITERS (smoke runs)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cuda:LOCAL_RANK under torchrun)")
    parser.add_argument("opts", nargs="*", help="KEY VALUE config overrides")
    return parser.parse_args(argv)


def step_seed(seed: int, step: int, rank: int = 0, world: int = 1) -> int:
    """torch's seed for train step ``step``: the counterpart of the JAX step's
    ``fold_in(rng, step)``, so the dropout masks depend on (SEED, step)
    alone. The JAX step draws one stream over the global batch; under data
    parallelism each data rank's rows draw their own, from (SEED, step,
    rank); the ranks of a model group draw alike."""
    key = (seed, step) if world == 1 else (seed, step, rank)
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])


def load_pretrained(model, path: str):
    """MODEL.PRETRAINED (``load_weights_auto``), loaded as far as its keys
    reach (the rest keeps its init)."""
    report = load_weights_auto(model, path)
    if report["matched"] == 0:
        raise ValueError(f"pretrained load from {path} matched 0 tensors")
    if report["missing"]:
        logger.warning(f"pretrained load from {path}: {len(report['missing'])} "
                       f"tensors stay at init (e.g. {report['missing'][:3]})")
    logger.info(f"initialized from MODEL.PRETRAINED: {path} "
                f"({report['matched']} tensors)")


def make_train_loader(config, dataset, device) -> DataLoader:
    """DATA.BATCH_SIZE samples a step from this data rank's shard of the
    sampler: the JAX loader's per-process shard
    (``emrt_tpu/data/loader.py:21-51``), so the global batch is the data
    ranks' batches in order."""
    return DataLoader(dataset, config.DATA.BATCH_SIZE, iterations=config.TRAIN.ITERS,
                      seed=config.SEED, num_workers=config.DATA.NUM_WORKERS,
                      device=device, shard_index=data_rank(), num_shards=data_world())


def spatial_rows(model, batch: dict) -> dict:
    """``batch`` as a rank of a spatially sharded ``model`` trains on it: its
    block of the image rows and label rows (the batch itself for a whole
    model)."""
    shard = getattr(model, "spatial", None)
    if shard is None:
        return batch
    return {"image": batch["image"][:, :, shard.rows(batch["image"].shape[2])],
            "label": batch["label"][:, shard.rows(batch["label"].shape[1])]}


def main(argv=None) -> dict:
    """Train; returns a summary: the first and last iteration of this run,
    the steps it took, the model forwards of its evaluations and of its
    FLOPs count, the windowed losses it logged and the mIoU of each
    evaluation."""
    args = parse_args(argv)
    config = update_config(get_config(), args)
    if args.seed is not None:
        config.SEED = args.seed
    if args.iters is not None:
        config.TRAIN.ITERS = args.iters
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (use --device cpu)")
    with distributed(args.device) as device, model_parallel(config.PARALLEL.MODEL,
                                                           config.PARALLEL.SPATIAL):
        return _train(args, config, device)


def _train(args, config, device) -> dict:
    world, n_data = world_size(), data_world()
    random.seed(config.SEED)
    np.random.seed(config.SEED)
    torch.manual_seed(config.SEED)
    model = get_model(config, device=device)
    check_parallel(config, world, model)
    if config.MODEL.PRETRAINED:
        load_pretrained(model, config.MODEL.PRETRAINED)
    n_params = sum(p.numel() for p in model.parameters())   # the whole model's
    logger.info(f"device: {device} ranks: {world} model params: {n_params / 1e6:.2f}M")
    build_kernels_once(model, device)
    # the FLOPs/params report (reference train.py:239-260), logged at the end,
    # counts the whole model: taken before the split
    cost = forward_cost(model, (1, 3, *config.DATA.CROP_SIZE), device) if is_main() else None
    split_for_the_group(config, model)
    shard_for_the_group(model)
    if world > 1:
        convert_sync_batchnorm(model)
    schedule = get_scheduler(config)
    optimizer = get_optimizer(config, model, schedule)
    loss_fn = get_loss_function(config)

    train_dataset = get_dataset(config, get_transforms(config), mode="train")
    val_dataset = get_dataset(config, build_val_transforms(config), mode="val")
    batch_size = config.DATA.BATCH_SIZE
    loader = make_train_loader(config, train_dataset, device)
    logger.info(f"train samples: {len(train_dataset)} val samples: "
                f"{len(val_dataset)} batch: {batch_size} a data rank, {batch_size * n_data} "
                f"in all")

    ckpt = CheckpointManager(config.SAVE_DIR, config.KEEP_CHECKPOINT_MAX)
    start_iter = 0
    if args.resume:
        start_iter = ckpt.restore(model, optimizer)
        loader.start_iter = start_iter
    trained = model
    if gradient_world() > 1:
        # BatchNorm statistics are equal on every rank (SyncBatchNorm):
        # nothing to broadcast
        trained = DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None,
            broadcast_buffers=False, process_group=gradient_group(),
            find_unused_parameters=getattr(model, "ddp_find_unused_parameters", False))
    train_step = make_train_step(trained, loss_fn, optimizer)
    summary = {"start_iter": start_iter, "last_iter": start_iter, "steps": 0,
               "eval_forwards": 0, "losses": [], "mious": []}

    def eval_forward(images):
        summary["eval_forwards"] += 1
        return model(images)[0]

    batch_cost = TimeAverager()
    reader_cost = TimeAverager()
    timer = Timer()
    it = start_iter
    window_losses = []   # this rank's device scalars; averaged at log time
    for batch in loader:
        reader_cost.record(timer.restart())
        it += 1
        torch.manual_seed(step_seed(config.SEED, it, data_rank(), n_data))
        window_losses.append(train_step(spatial_rows(model, batch)))
        summary["steps"] += 1
        log_now = it % config.LOGGING_INFO_FREQ == 0 or it == config.TRAIN.ITERS
        if log_now and device.type == "cuda":
            torch.cuda.synchronize(device)
        batch_cost.record(timer.restart(), num_samples=batch_size * n_data)

        if log_now:
            # each rank's loss is N x its share of its gradient group's global batch
            avg_loss = (all_reduce_gradient(torch.stack(window_losses).mean())
                        / gradient_world()).item()
            window_losses = []
            summary["losses"].append(avg_loss)
            eta = calculate_eta(config.TRAIN.ITERS - it, batch_cost.get_average())
            logger.info(
                f"[TRAIN] iter {it}/{config.TRAIN.ITERS} "
                f"loss: {avg_loss:.4f} lr: {schedule(it):.6f} "
                f"batch_cost: {batch_cost.get_average():.4f}s "
                f"reader_cost: {reader_cost.get_average():.4f}s "
                f"ips: {batch_cost.get_ips_average():.1f} ETA {eta}")
            batch_cost.reset()
            reader_cost.reset()

        if it % config.SAVE_FREQ_CHECKPOINT == 0 or it == config.TRAIN.ITERS:
            ckpt.save(it, model, optimizer)
        if it % config.VALIDATE_FREQ == 0 or it == config.TRAIN.ITERS:
            model.eval()
            with torch.inference_mode():
                result = evaluate(eval_forward, val_dataset, config, device)
            summary["mious"].append(result["miou"])
            ckpt.save_best(model, result["miou"])
        timer.restart()
    summary["last_iter"] = it
    if cost is not None:
        logger.info(f"model cost: {format_cost(cost)}")
    logger.info(f"training done at iter {it}; best mIoU {ckpt.best_miou:.4f}")
    return summary
