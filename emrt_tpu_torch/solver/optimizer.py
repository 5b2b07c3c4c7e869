"""SGD, Adam and AdamW in the JAX package's update order (counterpart of
``emrt_tpu/solver/optimizer.py``; reference src/models/solver/optimizer.py:21-75).

The JAX package chains optax transforms: clip by global norm, then
* SGD: add ``wd * p``, the momentum trace (Nesterov per config);
* Adam: add ``wd * p`` (L2 folded into the gradient), the bias-corrected
  moments ``m^ / (sqrt(v^) + eps)``;
* AdamW: the moments, then add ``wd * p`` (decoupled decay);
then scale by ``-lr(step)`` and by a multiplier per parameter: x0.1 for the
deformable ``sampling_offsets`` and ``reference_points`` (reference
transformer_encoder_decoder.py:36-38,371), else x TRAIN.DECODER_LR_COEF
for the model's ``decoder_lr_prefixes`` (SETR's and DPT's heads, reference
setr.py:121-151), else x1. Here the clip is done by hand (optax's form: no
epsilon, grads scaled by max_norm / norm only when norm >= max_norm), and
the rest is one ``torch.optim`` optimizer with a parameter group per
multiplier, whose learning rates are set to ``lr(step) x multiplier``
before every step: ``SGD`` (``wd * p`` before the momentum buffer, whose
first value is the gradient itself, as optax's trace from zeros), ``Adam``
(``weight_decay`` adds ``wd * p`` to the gradient) and ``AdamW`` (the
decay ``lr x wd x p`` of the group's learning rate, so the multiplier
scales it as optax's scales the sum). Adadelta and RMSProp wait
(ROADMAP.md queue 1, M5).
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


def lr_multiplier(name: str, decoder_prefixes=(), decoder_lr_coef: float = 1.0) -> float:
    """The learning-rate multiplier of the parameter ``name`` (the JAX
    package's ``param_labels``: the x0.1 rules first, then the decoder
    prefixes)."""
    if any(r in name for r in LR_MULT_RULES):
        return LR_MULT
    if decoder_lr_coef and any(name.startswith(p) for p in decoder_prefixes):
        return float(decoder_lr_coef)
    return 1.0


class _ScheduledOptimizer:
    """A ``torch.optim`` optimizer over ``named_parameters`` grouped by
    learning-rate multiplier (base, x0.1, decoder, in that order), with the
    schedule's lr per step. ``step()`` clips, updates and advances
    ``step_count``, the number of updates made, which is also the
    schedule's argument (optax's count)."""

    state_key = ""

    def __init__(self, named_parameters, schedule: Callable[[int], float], make,
                 grad_clip: float | None = None, decoder_prefixes=(),
                 decoder_lr_coef: float = 1.0):
        groups = {}
        for name, p in named_parameters:
            if p.requires_grad:
                mult = lr_multiplier(name, decoder_prefixes, decoder_lr_coef)
                kind = "slow" if mult == LR_MULT else "base" if mult == 1.0 else "decoder"
                groups.setdefault(kind, (mult, []))[1].append(p)
        groups = [{"params": groups[k][1], "lr_mult": groups[k][0]}
                  for k in ("base", "slow", "decoder") if k in groups]
        self.params = [p for g in groups for p in g["params"]]
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.step_count = 0
        self.optimizer = make(groups, schedule(0))

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
        return {self.state_key: self.optimizer.state_dict(), "step_count": self.step_count}

    def load_state_dict(self, state: dict):
        self.optimizer.load_state_dict(state[self.state_key])
        self.step_count = int(state["step_count"])


class SGD(_ScheduledOptimizer):
    state_key = "sgd"

    def __init__(self, named_parameters, schedule, momentum: float = 0.9,
                 nesterov: bool = False, weight_decay: float = 0.0,
                 grad_clip: float | None = None, **decoder):
        super().__init__(named_parameters, schedule, lambda groups, lr: torch.optim.SGD(
            groups, lr=lr, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay),
            grad_clip, **decoder)


class Adam(_ScheduledOptimizer):
    state_key = "adam"

    def __init__(self, named_parameters, schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip: float | None = None, **decoder):
        super().__init__(named_parameters, schedule, lambda groups, lr: torch.optim.Adam(
            groups, lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay),
            grad_clip, **decoder)


class AdamW(_ScheduledOptimizer):
    state_key = "adamw"

    def __init__(self, named_parameters, schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip: float | None = None, **decoder):
        super().__init__(named_parameters, schedule, lambda groups, lr: torch.optim.AdamW(
            groups, lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay),
            grad_clip, **decoder)


def get_optimizer(config, model: torch.nn.Module, schedule: Callable[[int], float]):
    """Build the optimizer of config.TRAIN.OPTIMIZER over ``model``'s
    parameters, TRAIN.DECODER_LR_COEF on its ``decoder_lr_prefixes``."""
    opt_cfg = config.TRAIN.OPTIMIZER
    name = opt_cfg.NAME.lower()
    common = dict(weight_decay=float(opt_cfg.WEIGHT_DECAY or 0.0), grad_clip=opt_cfg.GRAD_CLIP,
                  decoder_prefixes=tuple(getattr(model, "decoder_lr_prefixes", ())),
                  decoder_lr_coef=float(getattr(config.TRAIN, "DECODER_LR_COEF", 1.0)))
    if name == "sgd":
        return SGD(model.named_parameters(), schedule, momentum=opt_cfg.MOMENTUM,
                   nesterov=opt_cfg.NESTEROV, **common)
    if name in ("adam", "adamw"):
        cls = Adam if name == "adam" else AdamW
        return cls(model.named_parameters(), schedule, betas=tuple(opt_cfg.BETAS),
                   eps=float(opt_cfg.EPS), **common)
    raise NotImplementedError(f"optimizer {opt_cfg.NAME} is not ported yet "
                              f"(ROADMAP.md queue 1, M5)")
