"""Segmentation losses on NCHW logits (counterpart of
``emrt_tpu/losses/cross_entropy.py``; reference
src/models/losses/{cross_entropy_loss,mix_softmax_cross_entropy_loss}.py).

Masked-mean cross-entropy with ``ignore_index``, and the main + 0.4 x aux
mix that every EMRT config trains with. Logits are [n, C, H, W], labels
[n, H, W] integers; every reduction runs in float32. The mean divides by
max(count of kept pixels, 1), as the JAX package does, so a batch whose
labels are all ``ignore_index`` gives 0 (``F.cross_entropy``'s mean gives
NaN there). The other losses of the JAX package (MultiCE, OHEM) wait
(ROADMAP.md queue 1, M5).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_ce(logits, label, ignore_index: int = 255):
    """Mean cross-entropy over the pixels whose label is not ignore_index."""
    valid = label != ignore_index
    nll = F.cross_entropy(logits.float(), torch.where(valid, label, 0).long(),
                          reduction="none")
    return (nll * valid).sum() / valid.sum().clamp(min=1)


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
    if name in ("MultiCrossEntropyLoss", "OhemCrossEntropyLoss"):
        raise NotImplementedError(f"loss {name} is not ported yet "
                                  f"(ROADMAP.md queue 1, M5)")
    raise NotImplementedError(f"loss {name} is not supported")
