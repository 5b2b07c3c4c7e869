"""The reference training step: MixSoftmax cross-entropy (the main logits
plus 0.4 x the auxiliary ones, each a mean over the pixels whose label is
not ignored), clipping by the global gradient norm (optax's form: scaled
by max_norm / norm only where the norm reaches max_norm), then SGD with
momentum and L2 weight decay added to the gradient before the momentum
trace, whose first value is that sum itself, at the polynomial-decay
learning rate of the step count, x0.1 for the deformable sampling
offsets and the decoder's reference points. A parameter left without a
gradient is left as it is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

SLOW = ("sampling_offsets", "reference_points")


def masked_ce(logits, label, ignore_index: int):
    valid = label != ignore_index
    nll = F.cross_entropy(logits.float(), torch.where(valid, label, 0).long(), reduction="none")
    return (nll * valid).sum() / valid.sum().clamp(min=1)


def loss_fn(outputs, label, solver: dict):
    main, aux = outputs
    ignore = solver["ignore_index"]
    return masked_ce(main, label, ignore) + solver["aux_weight"] * masked_ce(aux, label, ignore)


def poly_lr(solver: dict, step: int) -> float:
    frac = min(step, solver["iters"]) / solver["iters"]
    return (solver["base_lr"] - solver["end_lr"]) * (1.0 - frac) ** solver["power"] + \
        solver["end_lr"]


class SGD:
    """State: the momentum trace of each parameter and the step count."""

    def __init__(self, named_parameters, solver: dict):
        self.params = [(n, p) for n, p in named_parameters if p.requires_grad]
        self.solver = solver
        self.trace = {}
        self.count = 0

    @torch.no_grad()
    def step(self):
        s = self.solver
        grads = {n: p.grad for n, p in self.params if p.grad is not None}
        norm = torch.linalg.vector_norm(torch.stack([g.float().norm() for g in grads.values()]))
        scale = (s["grad_clip"] / norm).clamp(max=1.0)
        lr = poly_lr(s, self.count)
        for n, p in self.params:
            if n not in grads:
                continue
            d = grads[n] * scale + s["weight_decay"] * p
            t = self.trace.get(n)
            self.trace[n] = d.clone() if t is None else t.mul_(s["momentum"]).add_(d)
            p.sub_(lr * (0.1 if any(k in n for k in SLOW) else 1.0) * self.trace[n])
        self.count += 1
