"""The rank-side halves of the tensor-parallel tests
(``test_torch_tensor_parallel.py``).

Each function runs on every rank of ``emrt_tpu_torch.parallel.launch.run_ranks``
(or in one process, where the world is 1): a spawned child that imports this
module, so the module imports neither JAX nor the JAX package. The ranks are
laid out as ``world / T`` data ranks by T model ranks
(``parallel.mesh.model_parallel``): rank r = d * T + m holds data rank d's
rows ``rows(n, d, world / T)`` of a global batch and model rank m's shard of
the model. The module holds no tests.
"""
from __future__ import annotations

import numpy as np
import torch

from emrt_tpu_torch import config as torch_config
from test_torch_parallel_ranks import (FLAGSHIP, NUM_CLASSES, ValDataset, linear_forward,
                                       make_loss, rows, val_config)

torch.set_num_threads(1)

# the tiny EMRT's learned reference points (the decoder's ``reference_points``
# Linear over its query embedding): every head's sampling locations send
# them gradient, the heads of all the model group's ranks
LEARNED_REFERENCE = ("model.reference_points.weight", "model.reference_points.bias",
                     "model.query_pos_embed.weight")


def _tiny_emrt(state_path, dropout):
    from emrt_tpu_torch.models.emrt import EMRT
    model = EMRT(num_classes=NUM_CLASSES, num_encoder_layers=1, num_decoder_layers=1)
    missing, unexpected = model.load_state_dict(torch.load(state_path, weights_only=True),
                                                strict=False)
    assert unexpected == [] and all(k.endswith("num_batches_tracked") for k in missing)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = dropout
    return model


def tp_train_step_rank(rank, world, t, state_path, image, label, dropout, clip=None, seed=0):
    """One step of the tiny EMRT-R50 (1 encoder and 1 decoder layer,
    float32, dropout ``dropout``) from the bridged weights at
    ``state_path`` with the flagship config's solver and loss, on a grid of
    ``world / t`` data ranks by ``t`` model ranks as the train CLI lays it
    out: the model split over its model group, SyncBatchNorm and DDP over
    its data group, torch seeded from (seed, step 1, data rank). Returns the
    loss as the train CLI logs it (the data ranks' mean), the gradient norm
    before the clip, the step count, the whole state dict (gathered over
    the model group), the replicated parameters of this rank's own model,
    the SGD momentum of ``LEARNED_REFERENCE`` after the step (the clipped
    gradient plus the weight decay's term) and, split, the spread of the
    replicated gradients over the model group before the optimizer gives
    them rank 0's (``GradientSync.spread``)."""
    from torch.nn.parallel import DistributedDataParallel

    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.parallel import convert_sync_batchnorm
    from emrt_tpu_torch.parallel.mesh import (all_reduce_data, data_group, data_rank,
                                              data_world, model_group, model_parallel,
                                              model_rank)
    from emrt_tpu_torch.parallel.tensor import gather_model_state, split_model_, splits_of
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import make_train_step
    from emrt_tpu_torch.train.cli import step_seed
    with model_parallel(t):
        model = _tiny_emrt(state_path, dropout)
        split = set(splits_of(model))
        split_model_(model, model_rank(), t, model_group())
        convert_sync_batchnorm(model)
        cfg = torch_config.get_config(str(FLAGSHIP))
        if clip is not None:
            cfg.TRAIN.OPTIMIZER.GRAD_CLIP = clip
        optimizer = get_optimizer(cfg, model, get_scheduler(cfg))
        if optimizer.sync is not None:
            optimizer.sync.spread = {}
        trained = model
        if data_world() > 1:
            trained = DistributedDataParallel(model, broadcast_buffers=False,
                                              process_group=data_group())
        step = make_train_step(trained, get_loss_function(cfg), optimizer)
        part = rows(len(label), data_rank(), data_world())
        torch.manual_seed(step_seed(seed, 1, data_rank(), data_world()))
        loss = step({"image": torch.from_numpy(image[part].transpose(0, 3, 1, 2).copy()),
                     "label": torch.from_numpy(label[part]).long()})
        loss = all_reduce_data(loss.clone()) / data_world()
        state = gather_model_state(model)
        params = dict(model.named_parameters())
        momentum = {k: optimizer.optimizer.state[params[k]]["momentum_buffer"].numpy()
                    for k in LEARNED_REFERENCE}
        return {"loss": loss.item(), "norm": optimizer.grad_norm.item(), "momentum": momentum,
                "steps": optimizer.step_count,
                "spread": None if optimizer.sync is None else dict(optimizer.sync.spread),
                "state": {k: v.numpy() for k, v in state.items()},
                "replicated": {k: p.detach().numpy().copy()
                               for k, p in model.named_parameters() if k not in split}}


def data_group_rank(rank, world, t, cases, shapes):
    """On a grid of ``world / t`` data ranks by ``t`` model ranks: for each
    (key, loss name, global NCHW logits list, global labels) of ``cases``
    the loss of this rank's data rows and the gradients of its logits, then
    ``evaluate`` of ``linear_forward`` over ``ValDataset(shapes)``: its
    summary and the shapes of the batches this rank predicted."""
    from emrt_tpu_torch.inference.evaluate import evaluate
    from emrt_tpu_torch.parallel.mesh import data_rank, data_world, model_parallel
    out = {}
    with model_parallel(t):
        for key, name, logits, label in cases:
            part = rows(len(label), data_rank(), data_world())
            ts = [torch.from_numpy(a[part]).requires_grad_(True) for a in logits]
            loss = make_loss(name)(ts, torch.from_numpy(label[part]).long())
            loss.backward()
            out[key] = {"loss": loss.item(), "grads": [g.grad.numpy() for g in ts]}
        seen = []

        def forward(x):
            seen.append(tuple(x.shape))
            return linear_forward(x)

        with torch.no_grad():
            result = evaluate(forward, ValDataset(shapes, seed=9),
                              val_config(torch_config, ()), "cpu", window_batch=2,
                              progbar=False)
        result.pop("val_time")
        out["evaluate"], out["seen"] = result, seen
    return out


def tp_clip_rank(rank, world, t, clip):
    """One clipped SGD step of a small deformable encoder-decoder (hidden
    64, 8 heads, FFN 128, one encoder and one decoder layer, dropout 0),
    split over ``t`` model ranks. The split parameters' gradients are
    scaled by 100 before the step (their shards alike), so that they carry
    most of the norm and a norm over the rank's shards alone would clip by
    another factor. Returns the norm before the clip, the split
    parameters' share of its square (one process only) and the whole state
    after the step."""
    from emrt_tpu_torch.models.deformable_transformer import EncoderDecoder
    from emrt_tpu_torch.parallel.mesh import model_group, model_parallel, model_rank
    from emrt_tpu_torch.parallel.tensor import (gather_model_state, gradient_sync,
                                                split_model_, splits_of)
    from emrt_tpu_torch.solver.optimizer import SGD
    torch.manual_seed(0)
    rng = np.random.default_rng(1)
    feats = [torch.from_numpy(rng.normal(size=(2, 16, s, s)).astype(np.float32))
             for s in (8, 4, 2)]
    psp = torch.from_numpy(rng.normal(size=(2, 12, 64)).astype(np.float32))
    with model_parallel(t):
        model = EncoderDecoder((16, 16, 16), num_queries=12, hidden_dim=64, nhead=8,
                               num_encoder_layers=1, num_decoder_layers=1,
                               num_encoder_points=2, num_decoder_points=2,
                               dim_feedforward=128, dropout=0.0)
        split = splits_of(model)
        split_model_(model, model_rank(), t, model_group())
        optimizer = SGD(model.named_parameters(), lambda step: 0.1, momentum=0.9,
                        grad_clip=clip, sync=gradient_sync(model))
        hs, memory = model(feats, psp)
        (hs.square().mean() + memory.tanh().mean()).backward()
        for name, p in model.named_parameters():
            if name in split:
                p.grad.mul_(100.0)
        share = None
        if t == 1:
            sq = {n: p.grad.double().square().sum() for n, p in model.named_parameters()}
            share = float(sum(sq[n] for n in split) / sum(sq.values()))
        optimizer.step()
        state = gather_model_state(model)
        return {"norm": optimizer.grad_norm.item(), "share": share,
                "state": {k: v.numpy() for k, v in state.items()}}


def tp_zoo_rank(rank, world, t, cls_path, kwargs, state_path, image, label):
    """An eval-mode forward and backward (cross-entropy of the main logits)
    of a zoo model (``models.<cls_path>``, built with ``kwargs``) from the
    state at ``state_path``, split over ``t`` model ranks. Returns every
    output's logits, the loss and the gradients gathered over the model
    group (zeros where a parameter has none)."""
    import importlib

    import torch.distributed as dist

    from emrt_tpu_torch.losses import CrossEntropyLoss
    from emrt_tpu_torch.parallel.mesh import model_group, model_parallel, model_rank
    from emrt_tpu_torch.parallel.tensor import join_tensor, split_model_, splits_of
    module, name = cls_path.rsplit(".", 1)
    model = getattr(importlib.import_module(f"emrt_tpu_torch.models.{module}"), name)(
        num_classes=NUM_CLASSES, **kwargs)
    missing, unexpected = model.load_state_dict(torch.load(state_path, weights_only=True),
                                                strict=False)
    assert unexpected == [] and all(k.endswith("num_batches_tracked") for k in missing)
    with model_parallel(t):
        specs = splits_of(model)
        split_model_(model, model_rank(), t, model_group())
        out = model.eval()(torch.from_numpy(image.transpose(0, 3, 1, 2).copy()))
        loss = CrossEntropyLoss(255)(out, torch.from_numpy(label).long())
        loss.backward()
        grads = {}
        for key, p in model.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            if key in specs and t > 1:
                parts = [torch.empty_like(g) for _ in range(t)]
                dist.all_gather(parts, g.contiguous(), group=model_group())
                g = join_tensor(parts, specs[key])
            grads[key] = g.numpy()
        return {"logits": [o.detach().numpy() for o in out], "loss": loss.item(),
                "grads": grads, "split": sorted(specs)}


def val_main_rank(rank, world, argv):
    """``val.main(argv)`` on this rank: its mIoU, images and forwards."""
    from emrt_tpu_torch.val import main as val_main
    result = val_main(argv)
    return {"miou": result["miou"], "images": result["images"], "forwards": result["forwards"]}
