"""Segmentation losses on NCHW logits (counterpart of
``emrt_tpu/losses/cross_entropy.py``; reference
src/models/losses/{cross_entropy_loss,mix_softmax_cross_entropy_loss,
multi_cross_entropy_loss,ohem_cross_entropy_loss}.py).

Masked-mean cross-entropy with ``ignore_index``, the main + 0.4 x aux mix
that every EMRT config trains with, the weighted sum over the outputs
(MultiCE, TRAIN.WEIGHTS) and online hard-example mining (OHEM, the JAX
package's fixed-shape form). Logits are [n, C, H, W], labels [n, H, W]
integers; every reduction runs in float32. The mean divides by max(count
of kept pixels, 1), as the JAX package does, so a batch whose labels are
all ``ignore_index`` gives 0 (``F.cross_entropy``'s mean gives NaN there).

Under data parallelism (``parallel/mesh.py``) the JAX package's mean is over
the global batch: the count of kept pixels (and OHEM's k-th probability) is
that of the rows of every rank of the gradient group together (the data
ranks and, under spatial parallelism, each one's spatial ranks, which hold
their own image rows and logits' rows; the ranks of a model group hold the
same rows). Each rank then returns N x (its rows' sum) / (the global
count), N the gradient group's ranks, so that the mean of the ranks' losses
is the global loss and DDP's average of the ranks' gradients is its
gradient; an all-ignored rank contributes 0. With one rank nothing changes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.mesh import all_reduce_gradient, gradient_rank, gradient_world


def _mean(total, count):
    """total / max(count, 1) of one process; under data (and spatial)
    parallelism this rank's share of the global mean, times the gradient
    group's ranks."""
    if gradient_world() == 1:
        return total / count.clamp(min=1)
    count = all_reduce_gradient(count.detach().float())
    return total * gradient_world() / count.clamp(min=1)


def masked_ce(logits, label, ignore_index: int = 255):
    """Mean cross-entropy over the pixels whose label is not ignore_index."""
    valid = label != ignore_index
    nll = F.cross_entropy(logits.float(), torch.where(valid, label, 0).long(),
                          reduction="none")
    return _mean((nll * valid).sum(), valid.sum())


class CrossEntropyLoss:
    """Masked-mean CE of the first logits (reference cross_entropy_loss.py:20-73)."""

    def __init__(self, ignore_index: int = 255):
        self.ignore_index = ignore_index

    def __call__(self, logits_list, label):
        logits = logits_list[0] if isinstance(logits_list, (list, tuple)) else logits_list
        return masked_ce(logits, label, self.ignore_index)


class MixSoftmaxCrossEntropyLoss:
    """CE(main) + aux_weight * sum CE(aux_i)
    (reference mix_softmax_cross_entropy_loss.py:20-51)."""

    def __init__(self, ignore_index: int = 255, aux: bool = True,
                 aux_weight: float = 0.4):
        self.ignore_index = ignore_index
        self.aux = aux
        self.aux_weight = aux_weight

    def __call__(self, logits_list, label):
        if not isinstance(logits_list, (list, tuple)):
            logits_list = [logits_list]
        loss = masked_ce(logits_list[0], label, self.ignore_index)
        if self.aux:
            for aux_logits in logits_list[1:]:
                loss = loss + self.aux_weight * masked_ce(aux_logits, label,
                                                          self.ignore_index)
        return loss


class MultiCrossEntropyLoss:
    """sum_i weights[i] x CE(logits_i), over as many outputs as there are
    weights (reference multi_cross_entropy_loss.py)."""

    def __init__(self, ignore_index: int = 255, weights=(1, 0.4, 0.4, 0.4, 0.4)):
        self.ignore_index = ignore_index
        self.weights = weights

    def __call__(self, logits_list, label):
        if not isinstance(logits_list, (list, tuple)):
            logits_list = [logits_list]
        loss = 0.0
        for w, logits in zip(self.weights, logits_list):
            loss = loss + w * masked_ce(logits, label, self.ignore_index)
        return loss


class OhemCrossEntropyLoss:
    """Online hard-example mining CE of the first logits (reference
    ohem_cross_entropy_loss.py:7-83), as the JAX package computes it without
    a boolean filter: with k = min(min_kept, pixels), the k-th smallest
    true-class probability (ignored pixels count as 1) raises the threshold
    to max(kth, thresh); the mean CE over the non-ignored pixels at or
    below it, divided by max(count, 1). Under data (and spatial)
    parallelism k and the k-th probability are those of the global flat
    batch: every rank of the gradient group holds as many pixels, its
    images' rows or its block of their rows, and ``kthvalue`` needs only
    the multiset of their probabilities."""

    def __init__(self, ignore_index: int = 255, thresh: float = 0.7,
                 min_kept: int = 10000):
        self.ignore_index = ignore_index
        self.thresh = thresh
        self.min_kept = min_kept

    def __call__(self, logits_list, label):
        logits = logits_list[0] if isinstance(logits_list, (list, tuple)) else logits_list
        valid = label != self.ignore_index
        safe = torch.where(valid, label, 0).long().unsqueeze(1)
        logits = logits.float()
        prob = F.softmax(logits, dim=1).gather(1, safe)[:, 0]
        nll = -F.log_softmax(logits, dim=1).gather(1, safe)[:, 0]
        true_prob = torch.where(valid, prob, 1.0).flatten()
        every = true_prob
        if gradient_world() > 1:      # the gradient group's rows, as one flat batch
            every = true_prob.new_zeros((gradient_world(), true_prob.numel()))
            every[gradient_rank()] = true_prob.detach()
            every = all_reduce_gradient(every).flatten()
        k = min(self.min_kept, every.numel())
        kth = torch.kthvalue(every, k).values
        keep = (true_prob <= kth.clamp(min=self.thresh)) & valid.flatten()
        return _mean((nll.flatten() * keep).sum(), keep.sum())


def get_loss_function(config):
    """(reference src/models/losses/__init__.py:6)."""
    name = config.TRAIN.LOSS
    ignore_index = config.TRAIN.IGNORE_INDEX
    if name == "MixSoftmaxCrossEntropyLoss":
        return MixSoftmaxCrossEntropyLoss(ignore_index=ignore_index,
                                          aux=config.MODEL.AUX.LOSS,
                                          aux_weight=config.MODEL.AUX.AUX_WEIGHT)
    if name == "CrossEntropyLoss":
        return CrossEntropyLoss(ignore_index=ignore_index)
    if name == "MultiCrossEntropyLoss":
        return MultiCrossEntropyLoss(ignore_index=ignore_index, weights=config.TRAIN.WEIGHTS)
    if name == "OhemCrossEntropyLoss":
        return OhemCrossEntropyLoss(ignore_index=ignore_index)
    raise NotImplementedError(f"loss {name} is not supported")
