"""SGD with momentum in the JAX package's update order (counterpart of
``emrt_tpu/solver/optimizer.py``; reference
src/models/solver/optimizer.py:21-75).

The JAX package chains optax transforms: clip by global norm, add
``wd * p``, momentum trace (Nesterov per config), scale by ``-lr(step)``, and
x0.1 for the deformable ``sampling_offsets`` and ``reference_points``
parameters (reference transformer_encoder_decoder.py:36-38,371). Here the
clip is done by hand (optax's form: no epsilon, grads scaled by
max_norm / norm only when norm >= max_norm), and the rest is one
``torch.optim.SGD`` with two parameter groups whose learning rates are set
from the schedule before every step: torch's SGD adds ``wd * p`` before the
momentum buffer, whose first value is the gradient itself, as optax's trace
from zeros. The other optimizers wait (ROADMAP.md queue 1, M5), and so does
``DECODER_LR_COEF``, which only the zoo's SETR and Segmenter decoders read.
"""
from __future__ import annotations

from typing import Callable

import torch

LR_MULT_RULES = ("sampling_offsets", "reference_points")   # x0.1 learning rate
LR_MULT = 0.1


def clip_by_global_norm_(grads, max_norm: float):
    """Scale ``grads`` in place to a global L2 norm of at most ``max_norm``
    (optax.clip_by_global_norm). Returns the norm before clipping, a device
    scalar: nothing here waits for the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, (max_norm / norm).clamp(max=1.0))
    return norm


class SGD:
    """Momentum SGD over ``named_parameters`` with the schedule's lr per step.

    ``step()`` clips, updates and advances ``step_count``, the number of
    updates made, which is also the schedule's argument (optax's count).
    """

    def __init__(self, named_parameters, schedule: Callable[[int], float],
                 momentum: float = 0.9, nesterov: bool = False,
                 weight_decay: float = 0.0, grad_clip: float | None = None):
        base, slow = [], []
        for name, p in named_parameters:
            if p.requires_grad:
                (slow if any(r in name for r in LR_MULT_RULES) else base).append(p)
        groups = [{"params": ps, "lr_mult": mult}
                  for ps, mult in ((base, 1.0), (slow, LR_MULT)) if ps]
        self.params = base + slow
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.step_count = 0
        self.optimizer = torch.optim.SGD(groups, lr=schedule(0), momentum=momentum,
                                         nesterov=nesterov, weight_decay=weight_decay)

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        if self.grad_clip:
            grads = [p.grad for p in self.params if p.grad is not None]
            clip_by_global_norm_(grads, float(self.grad_clip))
        lr = self.schedule(self.step_count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_mult"]
        self.optimizer.step()
        self.step_count += 1

    def state_dict(self) -> dict:
        return {"sgd": self.optimizer.state_dict(), "step_count": self.step_count}

    def load_state_dict(self, state: dict):
        self.optimizer.load_state_dict(state["sgd"])
        self.step_count = int(state["step_count"])


def get_optimizer(config, model: torch.nn.Module, schedule: Callable[[int], float]):
    """Build the optimizer of config.TRAIN.OPTIMIZER over ``model``'s parameters."""
    opt_cfg = config.TRAIN.OPTIMIZER
    if opt_cfg.NAME.lower() != "sgd":
        raise NotImplementedError(f"optimizer {opt_cfg.NAME} is not ported yet "
                                  f"(ROADMAP.md queue 1, M5)")
    return SGD(model.named_parameters(), schedule, momentum=opt_cfg.MOMENTUM,
               nesterov=opt_cfg.NESTEROV,
               weight_decay=float(opt_cfg.WEIGHT_DECAY or 0.0),
               grad_clip=opt_cfg.GRAD_CLIP)
