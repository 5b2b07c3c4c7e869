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
written to a temporary name first and then renamed into place.
"""
from __future__ import annotations

import json
import os
import re

import torch

from .logger import logger

_CKPT = re.compile(r"iter_(\d+)\.pt$")


def _save(obj, path: str):
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, save_dir: str, max_to_keep: int = 1):
        self.save_dir = os.path.abspath(save_dir)
        self.ckpt_dir = os.path.join(self.save_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
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
        _save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
               "step": step}, self.path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        logger.info(f"checkpoint saved at iter {step}")

    def save_best(self, model, miou: float) -> bool:
        if miou <= self.best_miou:
            return False
        self.best_miou = miou
        _save(model.state_dict(), os.path.join(self.save_dir, "best_model.pt"))
        with open(self._best_meta, "w") as f:
            json.dump({"best_miou": miou}, f)
        logger.info(f"best model saved (mIoU {miou:.4f})")
        return True

    def restore(self, model, optimizer, step: int | None = None) -> int:
        """Load the checkpoint of ``step`` (default: the latest) into
        ``model`` and ``optimizer``; returns its step, 0 if there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return 0
        state = torch.load(self.path(step), map_location="cpu", weights_only=True)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        logger.info(f"resumed from checkpoint at iter {step}")
        return int(state["step"])
