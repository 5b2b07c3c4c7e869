"""SGD, Adam, AdamW, Adadelta and RMSProp in the JAX package's update order
(counterpart of ``emrt_tpu/solver/optimizer.py``; reference
src/models/solver/optimizer.py:21-75).

The JAX package chains optax transforms: clip by global norm, then
* SGD: add ``wd * p``, the momentum trace (Nesterov per config);
* Adam: add ``wd * p`` (L2 folded into the gradient), the bias-corrected
  moments ``m^ / (sqrt(v^) + eps)``;
* AdamW: the moments, then add ``wd * p`` (decoupled decay);
* Adadelta (``scale_by_adadelta``): ``e_g = rho e_g + (1 - rho) g^2``,
  ``u = sqrt(e_x + eps) / sqrt(e_g + eps) g``, ``e_x = rho e_x + (1 - rho)
  u^2``, then add ``wd * p``;
* RMSProp (``scale_by_rms``): ``nu = rho nu + (1 - rho) g^2`` from 0,
  ``u = g / sqrt(nu + eps)`` (eps inside the root), then add ``wd * p``;
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
scales it as optax's scales the sum). ``torch.optim.RMSprop`` adds eps
outside the root, and it and ``torch.optim.Adadelta`` fold the decay into
the gradient before the scaling: Adadelta and RMSProp step with the
optimizers of this module (``OptaxAdadelta``, ``OptaxRMSProp``), whose
rules are optax's.

Over a model split by a model group (``parallel/tensor.py``) the step first
sums over the group the gradients of the replicated parameters read on a
head slice (and gives every other replicated one model rank 0's), then
clips by the norm of the whole model's gradient: each shard's square summed
over the group, each replicated tensor counted once, as optax's clip over
GSPMD's split tree. ``step`` runs after the backward, and DDP's hooks have
finished their all-reduce over the gradient group by the time
``backward()`` returns, so the sync reads the summed gradients.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..parallel.tensor import gradient_sync

LR_MULT_RULES = ("sampling_offsets", "reference_points")   # x0.1 learning rate
LR_MULT = 0.1


def clip_by_global_norm_(grads, max_norm: float, norm=None):
    """Scale ``grads`` in place to a global L2 norm of at most ``max_norm``
    (optax.clip_by_global_norm); ``norm``, where given, is the norm of the
    whole gradient (a split model's, ``GradientSync.global_norm``). Returns
    the norm before clipping, a device scalar: nothing here waits for the
    device."""
    if norm is None:
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
    schedule's argument (optax's count). ``names`` are the parameters'
    names in the torch optimizer's order; ``grad_norm`` is the last step's
    gradient norm before clipping (a device scalar; None without a clip).
    ``sync`` (``parallel.tensor.GradientSync``) is given for a split
    model."""

    state_key = ""

    def __init__(self, named_parameters, schedule: Callable[[int], float], make,
                 grad_clip: float | None = None, decoder_prefixes=(),
                 decoder_lr_coef: float = 1.0, sync=None):
        groups = {}
        for name, p in named_parameters:
            if p.requires_grad:
                mult = lr_multiplier(name, decoder_prefixes, decoder_lr_coef)
                kind = "slow" if mult == LR_MULT else "base" if mult == 1.0 else "decoder"
                groups.setdefault(kind, (mult, []))[1].append((name, p))
        groups = [{"params": [p for _, p in groups[k][1]], "names": [n for n, _ in groups[k][1]],
                   "lr_mult": groups[k][0]} for k in ("base", "slow", "decoder") if k in groups]
        self.params = [p for g in groups for p in g["params"]]
        self.names = [n for g in groups for n in g.pop("names")]
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.sync = sync
        self.grad_norm = None
        self.step_count = 0
        self.optimizer = make(groups, schedule(0))

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        if self.sync is not None:
            self.sync.reduce_(self.names, self.params)
        if self.grad_clip:
            have = [(n, p.grad) for n, p in zip(self.names, self.params) if p.grad is not None]
            grads = [g for _, g in have]
            norm = None if self.sync is None else self.sync.global_norm(
                grads, self.sync.is_split([n for n, _ in have]))
            self.grad_norm = clip_by_global_norm_(grads, float(self.grad_clip), norm)
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


class OptaxAdadelta(torch.optim.Optimizer):
    """optax's ``scale_by_adadelta`` then ``add_decayed_weights`` (decay
    after the scaling) and the group's ``-lr``."""

    def __init__(self, params, lr: float, rho: float = 0.9, eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, rho=rho, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            rho, eps, wd = group["rho"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["e_g"], state["e_x"] = torch.zeros_like(p), torch.zeros_like(p)
                e_g, e_x = state["e_g"], state["e_x"]
                e_g.mul_(rho).addcmul_(p.grad, p.grad, value=1.0 - rho)
                update = (e_x + eps).sqrt().div_((e_g + eps).sqrt()).mul_(p.grad)
                e_x.mul_(rho).addcmul_(update, update, value=1.0 - rho)
                if wd:
                    update.add_(p, alpha=wd)
                p.add_(update, alpha=-group["lr"])


class OptaxRMSProp(torch.optim.Optimizer):
    """optax's ``scale_by_rms`` (eps inside the root, the second moment
    from 0, no bias correction) then ``add_decayed_weights`` and the
    group's ``-lr``."""

    def __init__(self, params, lr: float, rho: float = 0.9, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, rho=rho, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            rho, eps, wd = group["rho"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(rho).addcmul_(p.grad, p.grad, value=1.0 - rho)
                update = (nu + eps).rsqrt().mul_(p.grad)
                if wd:
                    update.add_(p, alpha=wd)
                p.add_(update, alpha=-group["lr"])


class Adadelta(_ScheduledOptimizer):
    state_key = "adadelta"

    def __init__(self, named_parameters, schedule, rho: float = 0.9, eps: float = 1e-6,
                 weight_decay: float = 0.0, grad_clip: float | None = None, **decoder):
        super().__init__(named_parameters, schedule, lambda groups, lr: OptaxAdadelta(
            groups, lr=lr, rho=rho, eps=eps, weight_decay=weight_decay), grad_clip, **decoder)


class RMSProp(_ScheduledOptimizer):
    state_key = "rmsprop"

    def __init__(self, named_parameters, schedule, rho: float = 0.9, eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip: float | None = None, **decoder):
        super().__init__(named_parameters, schedule, lambda groups, lr: OptaxRMSProp(
            groups, lr=lr, rho=rho, eps=eps, weight_decay=weight_decay), grad_clip, **decoder)


def get_optimizer(config, model: torch.nn.Module, schedule: Callable[[int], float]):
    """Build the optimizer of config.TRAIN.OPTIMIZER over ``model``'s
    parameters, TRAIN.DECODER_LR_COEF on its ``decoder_lr_prefixes``; over a
    split model (``parallel.tensor.split_model_``, done before this) with the
    model group's gradient sum and norm."""
    opt_cfg = config.TRAIN.OPTIMIZER
    name = opt_cfg.NAME.lower()
    common = dict(weight_decay=float(opt_cfg.WEIGHT_DECAY or 0.0), grad_clip=opt_cfg.GRAD_CLIP,
                  decoder_prefixes=tuple(getattr(model, "decoder_lr_prefixes", ())),
                  decoder_lr_coef=float(getattr(config.TRAIN, "DECODER_LR_COEF", 1.0)),
                  sync=gradient_sync(model))
    if name == "sgd":
        return SGD(model.named_parameters(), schedule, momentum=opt_cfg.MOMENTUM,
                   nesterov=opt_cfg.NESTEROV, **common)
    if name in ("adam", "adamw"):
        cls = Adam if name == "adam" else AdamW
        return cls(model.named_parameters(), schedule, betas=tuple(opt_cfg.BETAS),
                   eps=float(opt_cfg.EPS), **common)
    if name in ("adadelta", "rmsprop"):
        cls = Adadelta if name == "adadelta" else RMSProp
        return cls(model.named_parameters(), schedule, rho=float(opt_cfg.RHO),
                   eps=float(opt_cfg.EPS), **common)
    raise NotImplementedError(f"optimizer {opt_cfg.NAME} is not supported")
