"""BatchNorm over the global batch of a data group (counterpart of flax
``BatchNorm`` under a batch sharded on the JAX mesh's ``data`` axis, whose
statistics GSPMD reduces over the global array; reference: the
``nn.SyncBatchNorm`` layers of semantic_segmentation). The ranks of a model
group hold the same rows, so the statistics are summed over the data group
(``mesh.data_group``), not the world. Under spatial parallelism
(``parallel/spatial.py``) a layer of the sharded region (``spatial_stats``
set) holds the rank's rows and sums over the gradient group (data x
spatial: n is the global N*H*W); a layer of the replicated region holds the
same whole maps on every rank of a spatial group and stays on the data
group. Its backward there gets only the rank's rows' part of dy; being
linear in dy, it passes that part on, and the gather's backward
(``SpatialShard.gather_rows``) adds the parts. ResNeSt's gate
(``SyncBatchNorm1d`` over the replicated global mean) is of the replicated
region too. Under tensor x spatial parallelism the groups are those of the
rank's model rank: the gradient group of equal m for the sharded region,
the data group of equal (m, s) for the replicated one, so the running
statistics come out equal on every rank of a data rank.

flax takes the statistics in float32 in one pass, mean = E[x] and var =
max(E[x^2] - E[x]^2, 0) (``use_fast_variance``), normalises with that biased
variance and moves its running variance toward it. Here each rank sums x and
x^2 per channel in float32 (bf16 inputs under autocast would cancel), one
all-reduce adds the sums and counts of every rank, and the result is flax's
formula over the global batch; the backward all-reduces the two per-channel
sums it needs. ``torch.nn.SyncBatchNorm`` is not used: it moves the running
variance toward the unbiased variance (fault F2, ``models/layers.py``).

``convert_sync_batchnorm`` changes the class of every ``models/layers.py``
BatchNorm in place, so parameters, buffers, state-dict keys and an optimizer
built before it stay as they are. Outside training mode, or with a data
group of one rank, the layers take exactly the path of
``BatchNorm2d`` / ``BatchNorm1d``.
"""
from __future__ import annotations

import torch

from ..models.layers import BatchNorm1d, BatchNorm2d
from .mesh import all_reduce_data, all_reduce_gradient, data_world, gradient_world


class _GlobalBatchNorm(torch.autograd.Function):
    """y = (x - mean) * rsqrt(var + eps) * weight + bias with the statistics
    of the global batch, in float32 at least; returns y in x's dtype, and
    the global (mean, biased var) for the running statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, all_reduce):
        dims = [0] + list(range(2, x.dim()))
        view = (1, -1) + (1,) * (x.dim() - 2)
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        c = x.shape[1]
        stats = torch.cat([xf.sum(dims), xf.square().sum(dims),
                           xf.new_full((1,), x.numel() // c)])
        all_reduce(stats)
        n = stats[-1]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean.square()).clamp(min=0.0)
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - mean.view(view)) * invstd.view(view)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.all_reduce = all_reduce
        y = xhat * weight.to(acc).view(view) + bias.to(acc).view(view)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, grad_y, _mean, _var):
        x, weight, mean, invstd, n = ctx.saved_tensors
        dims = [0] + list(range(2, x.dim()))
        view = (1, -1) + (1,) * (x.dim() - 2)
        c = x.shape[1]
        w = weight.to(mean.dtype)
        dy = grad_y.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean.view(view)) * invstd.view(view)
        grad_weight = (dy * xhat).sum(dims)
        grad_bias = dy.sum(dims)
        # the global sums of dxhat and dxhat * xhat: every rank's rows move
        # the statistics that every rank normalised with
        sums = torch.cat([grad_bias, grad_weight]) * w.repeat(2)
        ctx.all_reduce(sums)
        grad_x = (dy * w.view(view) - (sums[:c] / n).view(view)
                  - xhat * (sums[c:] / n).view(view)) * invstd.view(view)
        return (grad_x.to(x.dtype), grad_weight.to(weight.dtype), grad_bias.to(weight.dtype),
                None, None)


class _SyncMixin:
    spatial_stats = False     # a layer of a spatially sharded region

    def forward(self, x):
        world, all_reduce = ((gradient_world(), all_reduce_gradient) if self.spatial_stats
                             else (data_world(), all_reduce_data))
        if not (self.training and self.track_running_stats and world > 1):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, all_reduce)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.to(self.running_var.dtype), alpha=m)
        return y


class SyncBatchNorm2d(_SyncMixin, BatchNorm2d):
    """``BatchNorm2d`` whose training statistics are those of the global
    batch of every rank (n = the global N*H*W per channel)."""


class SyncBatchNorm1d(_SyncMixin, BatchNorm1d):
    """``BatchNorm1d`` over [n, c] vectors whose training statistics are
    those of the global batch (n = the global N)."""


def convert_sync_batchnorm(model: torch.nn.Module) -> torch.nn.Module:
    """Make every ``BatchNorm2d`` / ``BatchNorm1d`` of ``model`` a
    ``SyncBatchNorm2d`` / ``SyncBatchNorm1d`` in place; returns ``model``."""
    for m in model.modules():
        if type(m) is BatchNorm2d:
            m.__class__ = SyncBatchNorm2d
        elif type(m) is BatchNorm1d:
            m.__class__ = SyncBatchNorm1d
    return model
