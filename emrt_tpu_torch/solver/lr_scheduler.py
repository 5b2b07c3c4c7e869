"""Learning-rate schedules as plain ``step -> lr`` functions (counterpart of
``emrt_tpu/solver/lr_scheduler.py``; reference
src/models/solver/lr_scheduler.py:244-248).

Only PolynomialDecay is ported: every EMRT config trains with it. The
warm-up schedules wait (ROADMAP.md queue 1, M5).
"""
from __future__ import annotations


def polynomial_decay(base_lr: float, decay_steps: int, end_lr: float = 0.0,
                     power: float = 0.9):
    """lr(step) = (base - end) * (1 - min(step, decay_steps) / decay_steps)^power + end."""
    def schedule(step: int) -> float:
        frac = min(step, decay_steps) / decay_steps
        return (base_lr - end_lr) * (1.0 - frac) ** power + end_lr
    return schedule


def get_scheduler(config):
    """(reference lr_scheduler.py:243-267)."""
    name = config.TRAIN.LR_SCHEDULER.NAME
    if name == "PolynomialDecay":
        return polynomial_decay(config.TRAIN.BASE_LR, config.TRAIN.ITERS,
                                config.TRAIN.END_LR, config.TRAIN.POWER)
    raise NotImplementedError(f"scheduler {name} is not ported yet "
                              f"(ROADMAP.md queue 1, M5)")
