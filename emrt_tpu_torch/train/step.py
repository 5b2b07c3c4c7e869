"""The train step (counterpart of ``emrt_tpu/train/step.py``; reference
train.py:141-159: forward, loss, backward, optimizer step, lr step, clear
grads).

Eager PyTorch in place of one jitted function: the forward runs in train
mode (dropout on, BatchNorm on batch statistics, which it folds into the
running ones) under the model's own autocast, the loss in float32, then
backward and the optimizer's clip-and-update, which also advances the step.
Nothing in it waits for the device: the loss comes back as a device scalar.
"""
from __future__ import annotations

from typing import Callable


def make_train_step(model, loss_fn: Callable, optimizer):
    """Returns step(batch) -> loss (float32 device scalar).

    batch: {"image": [n, 3, H, W] float32, "label": [n, H, W] integer} on the
    model's device. ``optimizer`` holds the schedule and the step count
    (``solver.SGD``).
    """

    def train_step(batch):
        model.train()
        optimizer.zero_grad()
        loss = loss_fn(list(model(batch["image"])), batch["label"])
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step
