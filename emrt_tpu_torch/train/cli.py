"""Training CLI of the port (counterpart of the repo's ``train.py``; reference
contract: semantic_segmentation/train.py).

Usage: python3 -m emrt_tpu_torch.train --config <yaml> [--iters N] [--seed S]
       [--resume] [--device cuda|cpu] [KEY VALUE ...]

One device, eager PyTorch: the train step of ``train/step.py`` over the
threaded loader, windowed loss / lr / batch-cost / ips / ETA logging every
LOGGING_INFO_FREQ iterations, a checkpoint every SAVE_FREQ_CHECKPOINT
(newest KEEP_CHECKPOINT_MAX kept), and sliding-window ``evaluate`` every
VALIDATE_FREQ with the best mIoU's model saved; all three also at the last
iteration. ``--resume`` continues from the latest checkpoint in SAVE_DIR,
with the loader skipping the batches already consumed. MODEL.PRETRAINED
takes a reference ``.pdparams`` file. Multi-GPU, the FLOPs report and
orbax directories wait (ROADMAP.md queue 1, M12 and M13).
"""
from __future__ import annotations

import argparse
import random

import numpy as np
import torch

from ..config import get_config, update_config
from ..data import DataLoader, get_dataset, get_transforms
from ..inference import build_val_transforms, evaluate
from ..losses import get_loss_function
from ..models import get_model
from ..solver import get_optimizer, get_scheduler
from ..utils import TimeAverager, Timer, calculate_eta, logger
from ..utils.checkpoint import CheckpointManager
from ..utils.pdparams import load_pdparams, read_pdparams
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
                        help="torch device (default cuda)")
    parser.add_argument("opts", nargs="*", help="KEY VALUE config overrides")
    return parser.parse_args(argv)


def load_pretrained(model, path: str):
    """MODEL.PRETRAINED: a reference ``.pdparams`` state dict, loaded as far
    as its keys reach (the rest keeps its init)."""
    if not path.endswith(".pdparams"):
        raise NotImplementedError(
            f"MODEL.PRETRAINED {path}: the port loads .pdparams files; orbax "
            f"directories of the JAX package are not read")
    report = load_pdparams(model, read_pdparams(path))
    if report["matched"] == 0:
        raise ValueError(f"pretrained load from {path} matched 0 tensors")
    if report["missing"]:
        logger.warning(f"pretrained load from {path}: {len(report['missing'])} "
                       f"tensors stay at init (e.g. {report['missing'][:3]})")
    logger.info(f"initialized from MODEL.PRETRAINED: {path} "
                f"({report['matched']} tensors)")


def main(argv=None) -> dict:
    """Train; returns a summary: the first and last iteration of this run,
    the steps it took, the model forwards of its evaluations, the windowed
    losses it logged and the mIoU of each evaluation."""
    args = parse_args(argv)
    config = update_config(get_config(), args)
    if args.seed is not None:
        config.SEED = args.seed
    if args.iters is not None:
        config.TRAIN.ITERS = args.iters
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (use --device cpu)")

    random.seed(config.SEED)
    np.random.seed(config.SEED)
    torch.manual_seed(config.SEED)
    model = get_model(config, device=device)
    if config.MODEL.PRETRAINED:
        load_pretrained(model, config.MODEL.PRETRAINED)
    schedule = get_scheduler(config)
    optimizer = get_optimizer(config, model, schedule)
    loss_fn = get_loss_function(config)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"device: {device} model params: {n_params / 1e6:.2f}M")

    train_dataset = get_dataset(config, get_transforms(config), mode="train")
    val_dataset = get_dataset(config, build_val_transforms(config), mode="val")
    batch_size = config.DATA.BATCH_SIZE
    loader = DataLoader(train_dataset, batch_size, iterations=config.TRAIN.ITERS,
                        seed=config.SEED, num_workers=config.DATA.NUM_WORKERS,
                        device=device)
    logger.info(f"train samples: {len(train_dataset)} val samples: "
                f"{len(val_dataset)} batch: {batch_size}")

    ckpt = CheckpointManager(config.SAVE_DIR, config.KEEP_CHECKPOINT_MAX)
    start_iter = 0
    if args.resume:
        start_iter = ckpt.restore(model, optimizer)
        loader.start_iter = start_iter
    train_step = make_train_step(model, loss_fn, optimizer)
    summary = {"start_iter": start_iter, "last_iter": start_iter, "steps": 0,
               "eval_forwards": 0, "losses": [], "mious": []}

    def eval_forward(images):
        summary["eval_forwards"] += 1
        return model(images)[0]

    batch_cost = TimeAverager()
    reader_cost = TimeAverager()
    timer = Timer()
    it = start_iter
    window_losses = []   # device scalars; averaged at log time
    for batch in loader:
        reader_cost.record(timer.restart())
        it += 1
        window_losses.append(train_step(batch))
        summary["steps"] += 1
        log_now = it % config.LOGGING_INFO_FREQ == 0 or it == config.TRAIN.ITERS
        if log_now and device.type == "cuda":
            torch.cuda.synchronize(device)
        batch_cost.record(timer.restart(), num_samples=batch_size)

        if log_now:
            avg_loss = torch.stack(window_losses).mean().item()
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
    logger.info(f"training done at iter {it}; best mIoU {ckpt.best_miou:.4f}")
    return summary
