"""Evaluation CLI of the port (counterpart of the repo's ``val.py``;
reference contract: semantic_segmentation/val.py).

Usage: python3 -m emrt_tpu_torch.val --config <yaml> [--model_path <.pt | .pdparams>]
       [--multi_scales] [--device cuda] [KEY VALUE ...]
       torchrun --nproc_per_node N -m emrt_tpu_torch.val --config <yaml> ...

Without ``--model_path`` the weights come from the seeded init (config
SEED); with it, from a ``best_model.pt`` or ``iter_<n>.pt`` of the train CLI
or a reference ``.pdparams``, which must leave no tensor at init.
``--multi_scales`` or VAL.MULTI_SCALES_VAL run multi-scale + flip TTA. Prints
the per-class table and the model's FLOPs and parameters. Under ``torchrun``
the evaluation is sharded over the ranks (the repo's ``val.py:54-62``; one
GPU a rank, ``cuda:LOCAL_RANK``), every rank gets the whole result and rank
0 logs it and counts the FLOPs. With PARALLEL.MODEL = T > 1 the loaded model
is split over model groups of T ranks as ``train`` splits it, and the
evaluation is sharded over the data ranks, as ``train``'s evaluation runs
(the JAX ``val.py:53-61`` builds the mesh and leaves the parameters
replicated: the same numbers): ``torchrun --nproc_per_node 4 -m
emrt_tpu_torch.val --config <yaml> --model_path best_model.pt PARALLEL.MODEL 2``.
With PARALLEL.SPATIAL = S > 1 (an EMRT of any backbone or any zoo model;
``check_parallel``) the whole model runs on every rank and the
evaluation is sharded over the data ranks only (the S ranks of a spatial
group repeat it), as the JAX package evaluates under a spatial mesh.
"""
from __future__ import annotations

import argparse

import torch

from .config import get_config, update_config
from .data import get_dataset
from .inference import build_val_transforms, evaluate
from .models import get_model
from .parallel import check_parallel, distributed, is_main, world_size
from .parallel.mesh import build_kernels_once, model_parallel
from .parallel.tensor import split_for_the_group
from .utils import logger
from .utils.checkpoint import load_weights_auto
from .utils.flops import format_cost, forward_cost


def parse_args(argv=None):
    parser = argparse.ArgumentParser("EMRT evaluation (PyTorch port)")
    parser.add_argument("--config", dest="cfg", type=str, required=True)
    parser.add_argument("--model_path", type=str, default=None,
                        help="best_model.pt / iter_<n>.pt of the train CLI, or a "
                             "reference .pdparams state dict")
    parser.add_argument("--multi_scales", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cuda:LOCAL_RANK under torchrun)")
    parser.add_argument("opts", nargs="*")
    return parser.parse_args(argv)


def main(argv=None):
    """Evaluate; returns ``evaluate``'s summary plus ``forwards`` (the model
    forwards of the evaluation, this rank's) and ``cost`` (``forward_cost``;
    None but on rank 0)."""
    args = parse_args(argv)
    config = update_config(get_config(), args)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (use --device cpu)")
    with distributed(args.device) as device, model_parallel(config.PARALLEL.MODEL,
                                                           config.PARALLEL.SPATIAL):
        return _validate(args, config, device)


def _validate(args, config, device):
    torch.manual_seed(config.SEED)
    model = get_model(config, device=device).eval()
    check_parallel(config, world_size(), model)
    if args.model_path:
        report = load_weights_auto(model, args.model_path)
        if report["missing"]:
            raise ValueError(f"{args.model_path} lacks {len(report['missing'])} "
                             f"tensors, e.g. {report['missing'][:5]}")
        logger.info(f"loaded {report['matched']} tensors from {args.model_path} "
                    f"({len(report['unused'])} unused)")
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"device: {device} ranks: {world_size()} model params: {n_params / 1e6:.2f}M")
    build_kernels_once(model, device)
    cost = None
    if is_main():     # FLOPs / params (reference val.py:211-230) of the whole model
        size = config.VAL.IMAGE_BASE_SIZE or config.DATA.CROP_SIZE[0]
        if isinstance(size, int):
            size = (size, size)
        cost = forward_cost(model, (1, 3, *size), device)
    split_for_the_group(config, model)

    forwards = 0

    def forward(images):
        nonlocal forwards
        forwards += 1
        return model(images)[0]

    dataset = get_dataset(config, build_val_transforms(config), mode="val")
    with torch.inference_mode():
        result = evaluate(forward, dataset, config, device,
                          multi_scales=args.multi_scales or config.VAL.MULTI_SCALES_VAL)
    # paper-style per-class table (reference val.py:197-209)
    header = f"{'class':>8} {'IoU':>8} {'Prec':>8} {'Recall':>8} {'F1':>8}"
    logger.info(header)
    for c in range(config.DATA.NUM_CLASSES):
        logger.info(f"{c:>8d} {result['class_iou'][c]:>8.4f} "
                    f"{result['class_precision'][c]:>8.4f} "
                    f"{result['class_recall'][c]:>8.4f} "
                    f"{result['class_f1'][c]:>8.4f}")
    logger.info(f"final mIoU: {result['miou']:.4f} Acc: {result['acc']:.4f} "
                f"Kappa: {result['kappa']:.4f} mF1: {result['mf1']:.4f}")
    if cost is not None:
        logger.info(f"model cost: {format_cost(cost)}")
    result["forwards"], result["cost"] = forwards, cost
    return result


if __name__ == "__main__":
    main()
