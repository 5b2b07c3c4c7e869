"""The train and predict steps (counterpart of ``emrt_tpu/train/step.py``;
reference train.py:141-159: forward, loss, backward, optimizer step, lr
step, clear grads; predict.py:159-166).

Eager PyTorch in place of one jitted function: the forward runs in train
mode (dropout on, BatchNorm on batch statistics, which it folds into the
running ones) under the model's own autocast, the loss in float32, then
backward and the optimizer's clip-and-update, which also advances the step.
Nothing in it waits for the device: the loss comes back as a device scalar.

Under data parallelism (the JAX step over a batch sharded on ``data``) the
model is wrapped in ``DistributedDataParallel``: each rank runs its own rows,
the backward all-reduces and averages the gradients, so the clip's global
norm and the update are the same on every rank. The loss returned is the
rank's: world x its share of the global batch's (``losses/cross_entropy.py``),
so the ranks' mean is the global loss.
"""
from __future__ import annotations

from typing import Callable

import torch


def make_train_step(model, loss_fn: Callable, optimizer):
    """Returns step(batch) -> loss (float32 device scalar).

    model: the ``nn.Module``, or it wrapped in ``DistributedDataParallel``
    (then ``batch`` is this rank's rows). batch: {"image": [n, 3, H, W]
    float32, "label": [n, H, W] integer} on the model's device.
    ``optimizer`` holds the schedule and the step count (``solver.SGD``).
    """

    def train_step(batch):
        model.train()
        optimizer.zero_grad()
        loss = loss_fn(list(model(batch["image"])), batch["label"])
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def make_predict_step(model):
    """Returns predict(images [n, 3, H, W]) -> int32 labels [n, H, W]: the
    argmax of one whole-image eval forward's main logits, without softmax or
    resize."""

    def predict(images):
        model.eval()
        with torch.inference_mode():
            return model(images)[0].argmax(dim=1).to(torch.int32)

    return predict
