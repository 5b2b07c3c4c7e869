"""The yardstick: the card's peaks, the operations and bytes of the
deformable-attention kernels from their call shapes, and the operations of
a whole step or call.

Peaks (NVIDIA's data sheet, H100 SXM, dense): 989e12 bf16 FLOP/s on the
tensor cores, 3.35e12 bytes/s of HBM. A kernel's share of its roofline is
the least time its bytes take (each input read once, each output written
once) over its device time; a step's ``mfu`` is its matmul and convolution
operations (``torch.utils.flop_counter``, forward and backward) plus the
deformable kernels' over its time at the bf16 peak.
"""
from __future__ import annotations

import contextlib

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
FWD_KERNEL = "ms_deform_attn_fwd"
BWD_KERNEL = "ms_deform_attn_bwd"


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def deform_samples(sampling_locations) -> int:
    """Sampled points of a call: bs x Lq x heads x levels x points."""
    return sampling_locations.numel() // 2


def fwd_ops(value, sampling_locations) -> float:
    """K1: four corners a sample, one multiply-add a channel each."""
    return 8.0 * value.shape[-1] * deform_samples(sampling_locations)


def bwd_ops(value, sampling_locations) -> float:
    """The fused backward: per corner and channel a multiply-add into the
    dot product with grad_out and a product and an add into gV."""
    return 16.0 * value.shape[-1] * deform_samples(sampling_locations)


class DeformTally:
    """Bytes, operations and calls of the deformable kernels, counted from
    the shapes of the calls made while ``record()`` is open (it wraps the
    port's kernel entry points and restores them after)."""

    def __init__(self):
        self.calls = {"fwd": 0, "bwd": 0}
        self.bytes = {"fwd": 0, "bwd": 0}
        self.ops = {"fwd": 0.0, "bwd": 0.0}

    @contextlib.contextmanager
    def record(self):
        from emrt_tpu_torch.ops import deformable_cuda as dc
        fwd, bwd = dc.ms_deform_attn_fwd, dc.ms_deform_attn_bwd

        def counted_fwd(value, shapes, loc, attn, *args, **kw):
            out = fwd(value, shapes, loc, attn, *args, **kw)
            self.calls["fwd"] += 1
            self.bytes["fwd"] += nbytes((value, loc, attn, out))
            self.ops["fwd"] += fwd_ops(value, loc)
            return out

        def counted_bwd(value, shapes, loc, attn, grad_out, *args, **kw):
            grads = bwd(value, shapes, loc, attn, grad_out, *args, **kw)
            self.calls["bwd"] += 1
            self.bytes["bwd"] += nbytes((value, loc, attn, grad_out, *grads))
            self.ops["bwd"] += bwd_ops(value, loc)
            return grads

        dc.ms_deform_attn_fwd, dc.ms_deform_attn_bwd = counted_fwd, counted_bwd
        try:
            yield self
        finally:
            dc.ms_deform_attn_fwd, dc.ms_deform_attn_bwd = fwd, bwd


def count_ops(fn, params=()) -> float:
    """Operations of one call of ``fn``: the aten matmuls and convolutions
    it runs (``FlopCounterMode``, a multiply-add counted as 2) and the
    deformable kernels' (``DeformTally``). ``params`` (an eval model's) are
    taken out of autograd while it counts: the counter's module tracker
    hooks the gradient of inputs that require one."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    flags = [(p, p.requires_grad) for p in params]
    counter, tally = FlopCounterMode(display=False), DeformTally()
    try:
        for p, _ in flags:
            p.requires_grad_(False)
        with tally.record(), counter:
            fn()
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return float(counter.get_total_flops()) + tally.ops["fwd"] + tally.ops["bwd"]
