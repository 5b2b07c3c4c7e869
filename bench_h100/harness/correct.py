"""The numbers that decide ``correct``, each against its limit
(``limits/<workload>.json``).

Training (the program's first three steps against the reference's, on the
same weights, batches and dropout draws):

- ``loss_gap``: the largest |loss - reference loss| / |reference loss| of
  the three steps;
- ``grad_gap``: the worst leaf's |norm - reference norm| of the first
  update, the gradient as the optimizer took it (clipped, with its weight
  decay) times the step's learning rate, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same of each leaf's change over the three steps;
- ``grad_gap_median``, ``change_gap_median``: the median leaf's gap of each;
- ``logit_gap``: ||logits - reference|| / ||reference|| of the first
  step's main logits, as its train-mode forward made them.

Each cell's limits file names the numbers it compares.

Leaves whose first reference gradient is under a thousandth of the median
leaf's (or absent: a parameter no path reaches) are left out of both.

Sliding-window inference (the program's stitched logits of a call of the
window against the reference's over the same tiles):

- ``rms_gap``: ||logits - reference|| / ||reference||;
- ``argmax_gap``: the widest gap, over all pixels, by which the reference's
  logit of the class the program predicts lies below the reference's best,
  over the reference logits' root mean square.
"""
from __future__ import annotations

import math

import torch

SMALL_GRAD = 1e-3


def leaf_gaps(prog, ref, keep) -> torch.Tensor:
    """Each leaf's |prog - ref| / max(ref, median kept ref); NaN where the
    leaf is not kept."""
    p, r = prog.double(), ref.double()
    floor = r[keep].median()
    gaps = (p - r).abs() / torch.maximum(r, floor)
    return torch.where(keep, gaps, torch.full_like(gaps, math.nan))


def worst_leaves(prog: dict, ref: dict, key: str, n: int = 5):
    """The ``n`` kept leaves of ``key`` with the widest gaps: (name, gap,
    program norm, reference norm, reference gradient over the median's)."""
    grad1 = ref["grad1"].double()
    keep = grad1 >= SMALL_GRAD * grad1[grad1 > 0].median()
    gaps = leaf_gaps(prog[key], ref[key], keep)
    order = torch.argsort(torch.nan_to_num(gaps, nan=-1.0), descending=True)[:n]
    med = grad1[keep].median()
    return [(prog["names"][i], float(gaps[i]), float(prog[key][i]), float(ref[key][i]),
             float(grad1[i] / med)) for i in order.tolist()]


def train_readings(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses": [3 floats], "change1": [leaves], "change3":
    [leaves]} (norms by leaf, in the same order); ref also "grad1", the
    norms of its first raw gradients (0 where a leaf has none)."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    loss_gap = max(losses) if all(map(math.isfinite, prog["losses"])) else math.inf
    grad1 = ref["grad1"].double()
    keep = grad1 >= SMALL_GRAD * grad1[grad1 > 0].median()
    out = {"loss_gap": loss_gap, "logit_gap": rms_gap(prog["logits"], ref["logits"])}
    for name, key in (("grad_gap", "change1"), ("change_gap", "change3")):
        gaps = leaf_gaps(prog[key], ref[key], keep)
        finite = torch.isfinite(prog[key]).all() and keep.any()
        out[name] = float(gaps[keep].max()) if finite else math.inf
        out[f"{name}_median"] = float(gaps[keep].median()) if finite else math.inf
    return out


def rms_gap(prog, ref) -> float:
    """||prog - ref|| / ||ref||; infinite where prog is not finite or not
    of ref's shape."""
    if prog.shape != ref.shape or not torch.isfinite(prog).all():
        return math.inf
    prog, ref = prog.double(), ref.double()
    return float((prog - ref).norm() / ref.norm())


def slide_readings(pairs) -> dict:
    """pairs: (program logits, reference logits), each [bs, C, H, W]."""
    worst = {"rms_gap": 0.0, "argmax_gap": 0.0}
    for prog, ref in pairs:
        gap = rms_gap(prog, ref)
        if not math.isfinite(gap):
            return {"rms_gap": math.inf, "argmax_gap": math.inf}
        prog, ref = prog.double(), ref.double()
        chosen = ref.gather(1, prog.argmax(1, keepdim=True))
        widest = float((ref.amax(1, keepdim=True) - chosen).max() / ref.square().mean().sqrt())
        worst = {"rms_gap": max(worst["rms_gap"], gap),
                 "argmax_gap": max(worst["argmax_gap"], widest)}
    return worst


def judge(readings: dict, limits: dict):
    """(correct, [(name, value, limit)]): every reading finite and at or
    under its limit, and every limit read."""
    checks = [(name, readings.get(name, math.nan), limit) for name, limit in limits.items()]
    ok = all(math.isfinite(v) and v <= limit for _, v, limit in checks)
    return ok, checks
