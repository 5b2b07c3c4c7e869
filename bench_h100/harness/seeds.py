"""Everything a run draws from ``--seed``: named sub-seeds, the model's
weights and the inputs' random fields, all made on the run's device by a
``torch.Generator`` of its own (the default generator is left to the
program's dropout).

Weights follow one rule by shape, whatever the model: a normalisation
layer's scale 1 + 0.1 z and shift 0.1 z, a tenth of that where it ends a
ResNet block's residual branch; a convolution's kernel z x sqrt(2 /
fan_in); any other tensor of two or more dimensions z x sqrt(1 / its last
dimension); any other vector 0.02 z. The leaves are laid out by name in
one flat draw, so the same seed gives the same weights to any module tree
with the same names and shapes.

Why the tenth: with every residual branch at full scale, a randomly
initialised ResNet-50 trained with batch statistics is chaotic. Rounding
to bfloat16 then moves its first train-mode logits by half their norm
and float8 only twice that, so no comparison could tell the two apart
(the reference against itself at both precisions reads alike). Scaled
down, as ResNets are initialised for training (a zero-initialised last
BatchNorm in each block), each block starts near the identity.
"""
from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag`` within the run of ``seed`` (any integer)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


class WeightSpec:
    """(name, shape, scale, shift) of every parameter, sorted by name.
    ``norms``: the names of normalisation layers' parameters; ``residual``:
    those of them that end a residual branch."""

    def __init__(self, named_shapes, norms, residual=()):
        self.leaves = []
        self.numel = 0
        for name, shape in sorted(named_shapes):
            shape = tuple(shape)
            if name in norms:
                scale, shift = 0.1, 1.0 if name.endswith("weight") else 0.0
                if name in residual:
                    scale, shift = 0.1 * scale, 0.1 * shift
            elif len(shape) == 4:
                scale, shift = math.sqrt(2.0 / math.prod(shape[1:])), 0.0
            elif len(shape) >= 2:
                scale, shift = math.sqrt(1.0 / shape[-1]), 0.0
            else:
                scale, shift = 0.02, 0.0
            self.leaves.append((name, shape, scale, shift))
            self.numel += math.prod(shape)

    @classmethod
    def of(cls, model, norms, residual=()):
        return cls([(n, p.shape) for n, p in model.named_parameters()], norms, residual)

    def names(self):
        return [name for name, *_ in self.leaves]

    def values(self, seed: int, device):
        """{name: tensor} of the seed's weights (views of one flat draw)."""
        flat = torch.randn(self.numel, generator=generator(seed, "weights", device),
                           device=device)
        out, start = {}, 0
        for name, shape, scale, shift in self.leaves:
            n = math.prod(shape)
            out[name] = flat[start:start + n].view(shape).mul_(scale).add_(shift)
            start += n
        return out

    @torch.no_grad()
    def fill_(self, model, seed: int):
        """Copy the seed's weights into ``model``, whose parameters must be
        exactly these leaves; returns the model."""
        params = dict(model.named_parameters())
        if sorted(params) != self.names():
            missing = sorted(set(self.names()) - set(params))
            extra = sorted(set(params) - set(self.names()))
            raise ValueError(f"the model's parameters are not the reference's: missing "
                             f"{missing[:5]}, extra {extra[:5]}")
        device = next(iter(params.values())).device
        for name, value in self.values(seed, device).items():
            if tuple(params[name].shape) != tuple(value.shape):
                raise ValueError(f"{name}: shape {tuple(params[name].shape)}, the reference's "
                                 f"{tuple(value.shape)}")
            params[name].copy_(value)
        return model


def smooth_labels(gen, n: int, classes: int, size, cell: int, device):
    """[n, H, W] int64 class maps: the argmax of random class fields drawn on
    a grid of ``cell``-pixel cells and resized bilinearly, so that classes
    come in regions as in a land-cover map."""
    h, w = size
    field = torch.randn((n, classes, max(1, h // cell), max(1, w // cell)), generator=gen,
                        device=device)
    return torch.nn.functional.interpolate(field, size=(h, w), mode="bilinear",
                                           align_corners=False).argmax(1)


def images(gen, n: int, size, device):
    """[n, 3, H, W] float32 images, normalised as the loaders leave them:
    a smooth field per channel plus pixel noise, unit variance."""
    h, w = size
    low = torch.randn((n, 3, max(1, h // 16), max(1, w // 16)), generator=gen, device=device)
    smooth = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear",
                                             align_corners=False)
    noise = torch.randn((n, 3, h, w), generator=gen, device=device)
    return (smooth * 0.8 + noise * 0.6).contiguous()
