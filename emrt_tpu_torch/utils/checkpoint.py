"""Checkpoints of a training run (counterpart of the ``CheckpointManager`` of
``emrt_tpu/utils/checkpoint.py``; reference src/utils/checkpoint.py and the
deque rotation of train.py:197-229).

``torch.save`` files in place of orbax directories:
``SAVE_DIR/checkpoints/iter_<step>.pt`` holds the model's state dict (its
parameters and BatchNorm statistics), the optimizer's (momentum buffers and
step count) and the step, and only the newest ``max_to_keep`` stay.
``SAVE_DIR/best_model.pt`` holds the model of the best mIoU so far, which
``best_model.json`` records, so that a resumed run does not let its first
evaluation overwrite a better one from before the restart. Every file is
written to a temporary name first and then renamed into place. Under data
parallelism rank 0 writes (the model without DDP's wrapper, so its keys
have no ``module.`` prefix and one process reads them) while the other
ranks wait for it, and every rank restores. A model split over a model
group (``parallel/tensor.py``) is saved whole: its split tensors and their
optimizer state are gathered over the group first, so a file holds one
process's tensors under one process's names, and a restore cuts them to
the rank's shard, for any layout.
``load_weights_auto`` reads either file, or a reference ``.pdparams``, into
a model: ``val``, ``predict`` and MODEL.PRETRAINED load through it. A ViT
position table of another token count (weights trained at another crop) is
bilinearly re-interpolated on load (``interp_pos_embed``).
"""
from __future__ import annotations

import json
import math
import os
import re

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import barrier, is_main
from ..parallel.tensor import (gather_model_state, gather_optimizer_state, shard_model_state,
                               shard_optimizer_state)
from .logger import logger

_CKPT = re.compile(r"iter_(\d+)\.pt$")


def _save(obj, path: str):
    tmp = f"{path}.{os.getpid()}.tmp"
    if path.endswith(".json"):
        with open(tmp, "w") as f:
            json.dump(obj, f)
    else:
        torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, save_dir: str, max_to_keep: int = 1):
        self.save_dir = os.path.abspath(save_dir)
        self.ckpt_dir = os.path.join(self.save_dir, "checkpoints")
        if is_main():
            os.makedirs(self.ckpt_dir, exist_ok=True)
        barrier()
        self.max_to_keep = max(1, int(max_to_keep))
        self._best_meta = os.path.join(self.save_dir, "best_model.json")
        self.best_miou = -1.0
        if os.path.exists(self._best_meta):
            with open(self._best_meta) as f:
                self.best_miou = float(json.load(f)["best_miou"])

    def steps(self) -> list[int]:
        """Steps of the checkpoints on disk, oldest first."""
        found = (_CKPT.match(name) for name in os.listdir(self.ckpt_dir))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"iter_{step}.pt")

    def save(self, step: int, model, optimizer) -> None:
        """Every rank calls this (a split model's gather is a collective)."""
        state = {"model": gather_model_state(model),
                 "optimizer": gather_optimizer_state(optimizer, model), "step": step}
        if is_main():
            _save(state, self.path(step))
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        barrier()
        logger.info(f"checkpoint saved at iter {step}")

    def save_best(self, model, miou: float) -> bool:
        """Save ``model`` as the best one if ``miou`` beats the best so far
        (every rank evaluates to the same mIoU, and so decides alike)."""
        if miou <= self.best_miou:
            return False
        self.best_miou = miou
        state = gather_model_state(model)
        if is_main():
            _save(state, os.path.join(self.save_dir, "best_model.pt"))
            _save({"best_miou": miou}, self._best_meta)
        barrier()
        logger.info(f"best model saved (mIoU {miou:.4f})")
        return True

    def restore(self, model, optimizer, step: int | None = None) -> int:
        """Load the checkpoint of ``step`` (default: the latest) into
        ``model`` and ``optimizer`` (cut to the rank's shard of a split
        model); returns its step, 0 if there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return 0
        state = torch.load(self.path(step), map_location="cpu", weights_only=True)
        model.load_state_dict(shard_model_state(model, state["model"]))
        optimizer.load_state_dict(shard_optimizer_state(optimizer, model, state["optimizer"]))
        logger.info(f"resumed from checkpoint at iter {step}")
        return int(state["step"])


def interp_pos_embed(value: np.ndarray, target_shape, n_prefix: int = 1) -> np.ndarray:
    """Bilinearly re-interpolate a [1, prefix + N, D] ViT position table to
    ``target_shape``'s token count (``emrt_tpu/utils/checkpoint.py::
    _interp_pos_embed``; reference checkpoint.py:55-71). The grid is square;
    the first ``n_prefix`` rows (the cls token's) are kept as they are when
    both grids are squares without them or the source is no square with
    them."""
    src_tokens, dst_tokens = value.shape[1], target_shape[1]

    def square(n):
        return math.isqrt(n) ** 2 == n

    prefix = n_prefix if src_tokens != dst_tokens and not square(src_tokens) else 0
    if square(src_tokens - n_prefix) and square(dst_tokens - n_prefix):
        prefix = n_prefix
    head, grid = value[:, :prefix], value[:, prefix:]
    gs, ts = math.isqrt(grid.shape[1]), math.isqrt(dst_tokens - prefix)
    if gs * gs != grid.shape[1] or ts * ts != dst_tokens - prefix:
        raise ValueError(f"cannot interpolate pos_embed {value.shape} -> {tuple(target_shape)}")
    g = torch.from_numpy(np.ascontiguousarray(grid, np.float32)).reshape(1, gs, gs, -1)
    resized = F.interpolate(g.permute(0, 3, 1, 2), size=(ts, ts), mode="bilinear",
                            align_corners=False).permute(0, 2, 3, 1)
    return np.concatenate([head, resized.reshape(1, ts * ts, -1).numpy()], axis=1)


def _fit_pos_tables(model, state: dict) -> dict:
    """``state`` with its position tables of another token count
    re-interpolated to the model's."""
    target = model.state_dict()
    out = dict(state)
    for key, v in state.items():
        t = target.get(key)
        if (t is not None and key.endswith(("position_embeddings", "pos_embed"))
                and v.dim() == 3 and tuple(v.shape) != tuple(t.shape)):
            out[key] = torch.from_numpy(interp_pos_embed(v.float().numpy(), tuple(t.shape)))
    return out


def load_weights_auto(model, path: str) -> dict:
    """Load weights into ``model`` from a ``.pt`` file of this package (a
    model state dict, ``best_model.pt``, or the ``model`` entry of an
    ``iter_<n>.pt``) or a reference ``.pdparams`` state dict, a whole model
    or a prefix-less ImageNet ResNet (``utils/pdparams.py::load_pdparams``);
    the counterpart of ``emrt_tpu/utils/checkpoint.py::load_weights_auto``.
    Tensors the file lacks keep their values. Returns {matched, missing,
    unused}; raises on a tensor of another shape, but a position table,
    which is re-interpolated."""
    if path.endswith(".pdparams"):
        from .pdparams import load_pdparams, read_pdparams
        return load_pdparams(model, read_pdparams(path))
    if not path.endswith(".pt"):
        raise ValueError(f"{path}: the port loads .pt and .pdparams files; the JAX "
                         f"package's orbax directories are not read")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if {"model", "optimizer", "step"} <= state.keys():     # iter_<n>.pt
        state = state["model"]
    state = _fit_pos_tables(model, state)
    missing, unused = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    return {"matched": len(state) - len(unused), "missing": missing, "unused": unused}
