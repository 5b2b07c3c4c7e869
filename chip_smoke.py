#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``emrt_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0 requires a CUDA device, prints the software versions and the card's
name and power limit, and builds the deformable-attention kernels (K1 the
forward; the backward, one kernel for the TPU's K2 and K3) from
``emrt_tpu_torch/csrc``, one ``nvcc`` per source, all at once, printing
each kernel's registers and spills. Phase 1 holds K1 against its plain
PyTorch version at the flagship call shapes (bs 32; encoder Lq 1,344 and decoder Lq 110 over
levels 32^2, 16^2, 8^2; encoder Lq 5,376 over the 512^2 levels; the other
level sets below) with three
location sets, and at bs 8 (where the launch plan splits a (b, h) over
blocks) also with the other staging choice (the encoder calls stage their
value levels in shared memory, the decoder calls read them from global
memory); it prints each plan,
checks the wrappers' refusals and that an input requiring grad goes
through the autograd Function. ``time_fwd`` then times K1 and its plain
version at every call shape, bs 32 and 8, and K1's device time with the
plan's own split and staging and with the ones it did not choose.
Phase 2 drives the eval path: the full-width EMRT-R50 of
configs/EMRT/EMRT_256x256_160k_potsdam.yaml in bf16 with seeded random
weights, sliding-window ``evaluate`` (crop 256, stride 171, window batch 32)
over synthetic 1024^2 images, and checks that every model forward launched
K1 six times, that the logits are finite, that mIoU lies in [0, 1] and that
the logits through K1 match those through the plain core; it profiles one
32-window forward by kernel category.
Phase 3 drives the train path. 3a holds the backward against the plain
version's autograd at phase 1's shapes and location sets (and at bs 8, where
the launch plan splits a (b, h) over blocks) and times it on random
locations and on the grid at bs 32 and 8, at bs 8 also with the split the
plan did not choose; 3b holds the full-width model's loss and parameter gradients (batch 8,
dropout 0; float32 and bf16 with BatchNorm frozen, bf16 with BatchNorm on
batch statistics) through K1-K3 against those through the plain core; 3c runs the
trainer's entry point (``emrt_tpu_torch.train.main``) on the flagship config
with synthetic data at batch 8 with a save and an eval, checks the kernel
launch counts, the finite losses and ``--resume``, then times train steps at
batch 8 and 32 and profiles one batch-32 step by kernel category.
Phase 4 drives the backbone variants at full width in bf16 with seeded
random weights. For each variant yaml (CSwin, ViT-L, HRNet-W48, SegFormer-B4)
it runs ``evaluate`` over 2 synthetic 1024^2 images (window batch 32, at
the flagship's stride 171: the yamls' stride 320 over a 256 crop leaves
pixels no window covers, ROADMAP.md F5), 3 train steps at batch 8, the
loss and gradients through the kernels against the plain core (float32,
BatchNorm frozen), and prints windows/s, ms per train step and peak memory;
for ResNeXt50, ResNeSt50, resnet50c and resnet50 at output strides 16 and 8
one forward and one train step; and the trainer's entry point for 4
iterations on the ViT and HRNet yamls; and for the ResNet-50 yamls at
crops 224, 384 and 448 one forward and one train step at the yaml's crop.
Phase 5 drives the inference surface on the flagship yaml at full width and
depth in bf16 with seeded random weights: ``evaluate`` with multi-scale +
flip TTA at the yaml's geometry (8 images of 256^2, stride 256) and at
phase 2's (2 images of 1024^2, stride 171), a val batch of three mixed
shapes (the variable-shape path), each with its predictions through K1 held
against the plain core's (at least 99% of pixels agree) and its images/s
(one cold timing: a smoke timing, not a benchmark) and peak memory; then ``val.main`` on phase 3c's best_model.pt (the mIoU of
the training run's evaluation, within 1e-3) and ``predict.main`` on its
latest iter_<n>.pt (a PNG per image, in palette colours). Every path checks
its kernel launch counts (6 K1 launches a model forward, the FLOPs count's
forward included). Phases 1 and 3a also hold the kernels at the variants'
level shapes: three 16^2 levels (ViT), three 32^2 (HRNet, ResNet OS8) and
32^2/16^2/16^2 (ResNet OS16), and at the 224^2, 384^2 and 448^2 yamls'
levels (28/14/7, 48/24/12, 56/28/14).
Phase 6 drives the model zoo, which runs no deformable attention (none of
its paths may launch K1-K3): for the SETR-PUP, SETR-Naive, UperNet-Swin-T,
UperNet-CSwin-T, UperNet-Focal-B, DPT-Large and Trans2Seg Potsdam yamls and
the SETR-MLA ADE20K one, at full width and depth with seeded random
weights, one float32 window at the yaml's crop on the card against the same
model on the CPU (TF32 off; within 1e-3 x max|logit|), a bf16 ``evaluate``
of one 1024^2 image at stride 171 (windows/s, peak memory), six bf16
train steps at the yaml's batch with its optimizer (finite losses, ms per
step, peak memory) and one profiled step (the device's busy share); two
AdamW steps of the UperNet-Swin ADE20K yaml that trains with AdamW and two
Adam steps of the Trans10k Trans2Seg yaml; then ``train.main`` for a few
iterations on the SETR-PUP yaml with one save, and ``val.main`` on its
best_model.pt (the training run's mIoU within 1e-3). The same checks run
the ADE20K SegFormer-B5 (MiT-B5, depths 3/6/40/3), Segmenter ViT-L/16 with
the MaskTransformer, and DeiT-B with the MaskTransformer and with the
LinearDecoder. The solver phase then takes SegFormer-B0 two bf16 steps for
each optimizer, loss and schedule that no yaml uses (Adadelta, RMSProp;
MultiCE, OHEM; WarmupPolyLR, WarmupCosineLR, WarmupMultiStepLR; finite
losses, each step's lr equal to the schedule's: a check of the wiring,
the schedules' values are held to the JAX package's on the CPU).
Phase 7 drives data parallelism (``emrt_tpu_torch.parallel``) on the
flagship at full width and depth with seeded weights: two ranks, each a
process of its own (``parallel.launch.run_ranks``, a file store), on the
one card over gloo (NCCL refuses two ranks on one device). (a) One float32
DP step (dropout 0, SyncBatchNorm on batch statistics, DDP), 4 rows a rank,
against one process's step on the same 8 rows through the kernels; rank
1's rows have other classes, another image mean and scale and 80-100% of
their pixels ignored, so that a mean of the ranks' means or BatchNorm
statistics taken per rank show: the loss within DP_LOSS_RTOL, the
gradients within TRAIN_BN_GRAD_RTOL (L2), the BatchNorm running statistics
within 1e-4 x max; (b) 6 K1 and 6 backward launches a step on each rank;
(c) ``train.main --device cuda`` on both ranks, bf16, 8 rows a rank, with a
save and a sharded eval, then ``--resume``: finite losses equal on both
ranks, files written by rank 0 only, the launch counts, and one-process
``val.main`` on the DP run's best_model.pt within 1e-3 of its mIoU; (d)
each rank's bf16 DP step time and peak memory, which say nothing of
scaling while two ranks share a card. Where there are two cards, (a)-(d)
run again over NCCL, a card a rank; else the phase prints that the NCCL
leg was not run. (e) The CLIs as a user launches them: ``torchrun
--standalone --nproc_per_node 2 -m emrt_tpu_torch.train --device cuda``
for two iterations, then ``-m emrt_tpu_torch.val`` on its best_model.pt,
whose mIoU must be the run's within 1e-3.
Phase 8 drives tensor parallelism (``emrt_tpu_torch.parallel.tensor``,
PARALLEL.MODEL) on the flagship at full width and depth with seeded
weights, each rank a process of its own on the one card over gloo. (a) One
float32 dp1 x tp2 step of phase 7's 8 rows (dropout 0) against one
process's: the loss within DP_LOSS_RTOL, the gradients gathered over the
model group within TRAIN_BN_GRAD_RTOL (L2), the running statistics within
1e-4 x max, the gradient norm before the clip within TP_NORM_RTOL and the
gathered gradient's norm after it GRAD_CLIP; then a step with dropout 0.1
after which the replicated parameters are bitwise equal on both ranks; (b)
6 K1 and 6 backward launches a step on each rank, at 4 heads; (c)
``train.main --device cuda`` on four ranks as dp2 x tp2, bf16, with a save,
a sharded eval and ``--resume``: finite losses equal on all ranks, files
written by rank 0 only and holding the one-process model's tensors, the
launch counts, and one-process ``val.main`` on the run's best_model.pt
within 1e-3 of its mIoU; (d) each rank's bf16 dp1 x tp2 step time and peak
memory (a smoke figure: the ranks share a card). Where there are two cards
(a), (b) and (d) run again over NCCL, a card a rank, and (c) where there are
four; else the phase prints that the NCCL leg was not run. (e) ``torchrun
--standalone --nproc_per_node 2 -m emrt_tpu_torch.train --device cuda ...
PARALLEL.MODEL 2`` for two iterations. Phases 1 and 3a also hold the kernels
at a TP rank's 4 and 2 heads at the flagship's encoder and decoder calls
(TP_SHAPES, bs 32 and 8), and ``time_fwd`` / ``time_bwd`` time them at bs 32.
Phase 9 drives spatial parallelism (``emrt_tpu_torch.parallel.spatial``,
PARALLEL.SPATIAL) on the flagship at full width and depth with seeded
weights, each rank a process of its own on the one card over gloo. (a) One
float32 dp1 x sp2 step of phase 7's 8 rows, each rank on 128 of their 256
image rows, dropout 0.1 with torch seeded alike, against one process's
step (``dp_reference`` with that dropout): the loss within DP_LOSS_RTOL,
the gradients within TRAIN_BN_GRAD_RTOL (L2), the running statistics
within 1e-4 x max, the gradient norm before the clip within SP_NORM_RTOL,
and the parameters and buffers bitwise equal on both ranks after it; (b)
6 K1 and 6 backward launches on each rank, at 8 heads and the full 1,344 /
110 queries (the encoder-decoder runs whole on every rank); (c)
``torchrun --standalone --nproc_per_node 2 -m emrt_tpu_torch.train
--device cuda ... PARALLEL.SPATIAL 2`` for two iterations, then
one-process ``val.main`` on its best_model.pt within 1e-3 of its mIoU; (d)
bf16 steps of 2 x 1024^2 crops (where activations dominate), one process
against each dp1 x sp2 rank, each in fresh processes: ms a step, peak
memory, the memory of the weights, gradients and optimizer state, and the
activations each region of the model adds in the forward (a memory figure:
the ranks share one card over gloo). Where there are two cards, (a), (b)
and (d) run again over NCCL, a card a rank.
Phase 10 drives tensor x spatial parallelism and the spatial sharding of the
HRNet and ResNeSt EMRTs at full width and depth with seeded weights, each
rank a process of its own on the one card over gloo. (a) One float32 dp1 x
tp2 x sp2 step of the flagship on phase 7's 8 rows (four ranks: the
transformer split over each model group, 128 of the 256 image rows a
spatial rank), dropout 0.1, against one process's step (``dp_reference``
with that dropout), with phase 9 (a)'s checks and bounds, the gradients
gathered over the model group, the replicated gradients' spread over the
model group before ``GradientSync`` (TP_SPREAD_TOL), and the gathered
states and the replicated parameters bitwise equal on the four ranks; (b)
the same for dp1 x sp2 steps of the HRNet-W48 EMRT
(EMRT_256x256_160k_potsdam_hrnet.yaml) and of the ResNeSt-50 EMRT, each
against one process's step of its own; (c) 6 K1 and 6 backward launches
in each rank's step, at 4 heads under tp2 and 8 in (b), at the full token
counts (1,344 / 110; the HRNet EMRT's 3,072 / 110); (d) ``torchrun
--standalone --nproc_per_node 4 -m emrt_tpu_torch.train --device cuda ...
PARALLEL.MODEL 2 PARALLEL.SPATIAL 2`` for two iterations, then one-process
``val.main`` on its best_model.pt within 1e-3 of its mIoU; (e) phase 9
(d)'s bf16 step at 2 x 1024^2 for the HRNet EMRT, one process against each
dp1 x sp2 rank: ms, peak memory and each region's activations (a memory
figure: the ranks share one card). Each step of (a) and (b) also prints its
control: how far one process's own gradient norm moves when its images
move by one float32 ulp of 1 (relative), the scale of float32 rounding on
that input; the step's norm is held within SP_NORM_RTOL of one process's,
or within CONTROL_FACTOR x the control where that is larger. Phases 1 and
3a also hold the kernels at the HRNet EMRT's calls at a tp2 rank's 4
heads, and ``time_fwd`` / ``time_bwd`` time them.
Phase 11 drives spatial parallelism of the paper's transformer-backbone
EMRTs (EMRT_cswin_, EMRT_vit_ and EMRT_segformerb4_256x256_160k_potsdam.yaml:
each rank's attentions take its tokens' queries over the keys and values
gathered from its spatial group) at full width and depth with seeded
weights, each rank a process of its own on the one card over gloo. (a)
One float32 dp1 x sp2 step of each on phase 7's 8 rows, dropout 0.1 (the
backbones' DropPath at the rates they set), against one process's step,
with phase 10 (b)'s checks and bounds (``phase10_backbone``); (b) ViT-L's
dp1 x tp2 x sp2 step with phase 10 (a)'s, the replicated gradients'
spread over the model group included; (c) 6 K1 and 6 backward launches in
each rank's step, at 8 heads in (a) and 4 in (b), at 1,344 / 110 queries
(CSwin, SegFormer-B4) and 768 / 110 (ViT-L); (d) phase 9 (d)'s bf16 step,
one process against each dp1 x sp2 rank, at 2 x 1024^2 for CSwin and
SegFormer-B4 and 2 x 768^2 for ViT-L (ms, peak memory, each region's
activations; a memory figure: the ranks share one card). Phases 1 and 3a
also hold the kernels at ViT-L's calls at 768^2 (three 48^2 levels, Lq
6,912 and 110), and ``time_fwd`` / ``time_bwd`` time them. Phase 10 (b)
and (e)'s rank steps run in one start of the two ranks, and (e)'s one
process after them (``sharded_steps``): a start of the ranks costs 15-25
s. The whole script runs phase 11 (a) and
(b) at a cut depth (DEPTH_CUT: CSwin's stage 3 at 2 of its 21 blocks,
ViT-L at 8 of its 24 layers), to make room for phase 12 in its time
limit; ``--transformer-sp`` runs them at full depth.
Phase 12 drives spatial parallelism of the zoo's global-attention models,
which shard whole (every module on a rank's rows: the heads' resizes with
a halo row, DPT's readout of spatial rank 0's cls token on every rank,
the Segmenter's class tokens replicated), at full width and depth with
seeded weights, each rank a process of its own on the one card over gloo.
(a) One float32 dp1 x sp2 step of phase 7's 8 rows at 256^2, dropout 0.1
on every dropout layer and DropPath at the yamls' rates, of SETR-PUP-L
(SETR_PUP_Large_256x256_160k_potsdam_bs_8.yaml), SETR-MLA-L, DPT-L
(readout ``project``), the Segmenter ViT-L and DeiT-B distilled with the
mask transformer, and SegFormer-B5 (the 512^2 yamls built at a 256 crop;
a clip of 1.0 where the yaml sets none), each against one process's step
with phase 10 (b)'s checks and bounds (``sharded_steps``); (b) SETR-PUP-L's
dp1 x tp2 x sp2 step with phase 10 (a)'s; (c) no launch of K1 or the
backward in any rank's step; (d) phase 9 (d)'s bf16 step of SETR-PUP-L at
2 x 768^2 (the cityscapes yaml's crop), one process against each dp1 x
sp2 rank (ms, peak memory, the activations of ``encoder``, ``decoder``
and the ``aux_decoder*`` heads). The whole script runs phase 12 (a) and
(b) at a cut depth (ZOO_DEPTH_CUT: the ViT-L encoders of SETR-PUP-L,
SETR-MLA-L, DPT-L and the Segmenter at 8 of their 24 layers, DeiT-B at 4
of 12, SegFormer-B5's third stage at 8 of 40 blocks), to make room for
phase 13 in its time limit; (d) runs at full depth.
Phase 13 drives spatial parallelism of the rest of the zoo at full width
and depth with seeded weights: UperNet with a Swin, CSwin or Focal
backbone (sharded whole: the window, stripe and focal attentions of the
rank's rows over the map gathered from the group, the UperHead's pyramid
pooling over its gathered top map on every rank), Trans2Seg (the ResNet
and the CNN head on the rank's rows, the transformer whole on every rank
over the gathered c4) and FCN. (a) One float32 dp1 x sp2 step of phase 7's
8 rows at 256^2 as phase 12 (a)'s, of UperNet-Swin-T, UperNet-CSwin-T and
UperNet-Focal-B from their Potsdam yamls (512^2, built at a 256 crop),
Trans2Seg-medium (Trans2Seg_medium_256x256_160k_potsdam.yaml) and FCN-R50c
at output stride 8 (the flagship's yaml with MODEL.NAME FCN), each against
one process's step (the two ResNet-50c models in float64, SP_FLOAT64: in
float32 their BatchNorms amplify rounding past what the norm's control
bounds); (b) Trans2Seg's dp1 x tp2 x sp2 step with phase 10 (a)'s checks,
in float64; (c) no launch of K1 or the backward in any rank's step; (d)
UperNet-Swin-T's bf16 step at 2 x 1024^2, one process against each dp1 x
sp2 rank (ms, peak memory, the activations of ``encoder``, ``decoder`` and
``aux_decoder``). Phases 11, 12 and 13 run their (a) and (d) rank steps
in one start of the two ranks, their (b) steps in one start of the four,
and their (d) one-process steps in one process (``sp_phases``).

Any failed check raises, and the script then exits non-zero without the
final line. ``python3 chip_smoke.py --tp-step`` runs phase 0 and phase 8's
dp1 x tp2 step alone, ``--sp-step`` phase 0 and phase 9 without (c),
``--tpsp-step`` phase 0 and phase 10 without (d), ``--transformer-sp``
phase 0 and phase 11 at full depth, ``--zoo-sp`` phase 0 and phases 12
and 13 at full depth,
``--norm-seeds`` phase 0
and phase 10 (b) from each seed of NORM_SEEDS (every reading printed
before a check fails),
``--train-step`` phase 0 and phase 3c's timing of one process's bf16 bs-8
train step alone; none prints the final lines. It prints its own time, then a JSON object describing each
kernel on the second-to-last line; the last line is {"ok": true, "device":
{...}}. Nothing here imports JAX.
"""
from __future__ import annotations

import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "EMRT" / "EMRT_256x256_160k_potsdam.yaml"
BS, HEADS, HEAD_DIM, POINTS = 32, 8, 32, 6
LEVELS_256 = ((32, 32), (16, 16), (8, 8))
LEVELS_512 = ((64, 64), (32, 32), (16, 16))
LEVELS_VIT = ((16, 16),) * 3                       # ViT's taps, all at stride 16
LEVELS_VIT768 = ((48, 48),) * 3                    # ViT's taps at 768^2 (phase 11 (d))
LEVELS_32X3 = ((32, 32),) * 3                      # HRNet, ResNet at output stride 8
LEVELS_OS16 = ((32, 32), (16, 16), (16, 16))       # ResNet at output stride 16
# the 224^2, 384^2 and 448^2 yamls (ResNet-50 at output stride 32)
LEVELS_224 = ((28, 28), (14, 14), (7, 7))
LEVELS_384 = ((48, 48), (24, 24), (12, 12))
LEVELS_448 = ((56, 56), (28, 28), (14, 14))
SHAPES = (("encoder 256^2", LEVELS_256, 1344),
          ("decoder 256^2", LEVELS_256, 110),
          ("encoder 512^2", LEVELS_512, 5376),
          ("encoder 16^2x3", LEVELS_VIT, 768),
          ("decoder 16^2x3", LEVELS_VIT, 110),
          ("encoder 32^2x3", LEVELS_32X3, 3072),
          ("decoder 32^2x3", LEVELS_32X3, 110),
          ("encoder 32/16/16", LEVELS_OS16, 1536),
          ("decoder 32/16/16", LEVELS_OS16, 110),
          ("encoder 224^2", LEVELS_224, 1029),
          ("decoder 224^2", LEVELS_224, 110),
          ("encoder 384^2", LEVELS_384, 3024),
          ("decoder 384^2", LEVELS_384, 110),
          ("encoder 448^2", LEVELS_448, 4116),
          ("decoder 448^2", LEVELS_448, 110),
          ("encoder 48^2x3", LEVELS_VIT768, 6912),
          ("decoder 48^2x3", LEVELS_VIT768, 110))
# tensor parallelism (phase 8): a rank of a model group of T runs the
# flagship's calls at 8 / T heads, T = 2 and 4; and the HRNet EMRT's (three
# 32^2 levels, SHAPES[5:7]) at 4 heads
TP_HEADS = (4, 2)
TP_SHAPES = tuple((f"{name} nh {h}", levels, len_q, h) for h in TP_HEADS
                  for name, levels, len_q in SHAPES[:2]) + tuple(
    (f"{name} nh 4", levels, len_q, 4) for name, levels, len_q in SHAPES[5:7])
N_IMAGES, IMAGE_SIZE, WINDOW_BATCH = 8, 1024, 32
# bf16 model logits through K1 against the plain core: K1's f32 sums differ
# from the plain version's in order only, so some deformable outputs round
# to the neighbouring bf16 value; that one-ulp drift flows through the bf16
# layers after it, and the logits are bf16 too (one ulp at |x| in [16, 32)
# is 0.125, ~0.7% of a max logit near 19): the bound allows ~3 such ulps
MODEL_RTOL = 2e-2
# the model's loss and gradients (relative L2 over all parameters) through
# K1-K3 against the plain core, same weights and batch. With BatchNorm frozen
# the network passes a perturbation of the deformable output on at about its
# size: in float32 the two paths differ in f32 sum order only (F32_GRAD_RTOL),
# in bf16 by one-ulp flips of deformable outputs and gradients (MODEL_RTOL,
# as the logits). With BatchNorm on batch statistics, as training runs it,
# the backward amplifies: on the H100, a 1e-7 relative perturbation of the
# deformable output moved the float32 gradients by 8.8e-4, and two runs of
# the same bf16 plain path differed by 2.0e-2 (cuDNN sums in no fixed
# order); there the bound is a sanity bound (TRAIN_BN_GRAD_RTOL).
F32_GRAD_RTOL, LOSS_RTOL, TRAIN_BN_GRAD_RTOL = 1e-4, 1e-3, 0.25
TRAIN_BS, TRAIN_ITERS, RESUME_ITERS = 8, 20, 24
# train.main ends with the FLOPs report: one eval forward of one image
FLOPS_FORWARDS = 1
# an H100 SXM's HBM rate and float32 peak outside the tensor cores (data sheet)
HBM_BYTES_S, F32_FLOP_S = 3.35e12, 67e12


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _counts():
    """(forward launches, backward launches)"""
    from emrt_tpu_torch.ops import deformable_cuda
    return deformable_cuda.launches, deformable_cuda.bwd_launches


def _reset_counts():
    from emrt_tpu_torch.ops import deformable_cuda
    deformable_cuda.launches = deformable_cuda.bwd_launches = 0


def _valid_corners(levels, loc) -> float:
    """How many corners of all the samples of ``loc`` lie inside their maps."""
    import torch
    n = 0.0
    for lvl, (h, w) in enumerate(levels):
        per_axis = []
        for axis, size in ((0, w), (1, h)):
            c0 = torch.floor(loc[..., lvl, :, axis] * size - 0.5)
            per_axis.append(((c0 >= 0) & (c0 < size)).float()
                            + ((c0 + 1 >= 0) & (c0 + 1 < size)).float())
        n += (per_axis[0] * per_axis[1]).sum().item()
    return n


def bound(tensors, flops):
    """The least time the card takes for work that reads or writes each of
    ``tensors`` once and does ``flops`` float32 operations: (ms, "bytes" or
    "operations"), whichever is larger."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` runs."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase0():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    import emrt_tpu_torch
    check(Path(emrt_tpu_torch.__file__).resolve().is_relative_to(ROOT),
          f"emrt_tpu_torch imported from outside the checkout: {emrt_tpu_torch.__file__}")
    from emrt_tpu_torch.ops import deformable_cuda
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    deformable_cuda.build()
    print(f"phase 0: the forward and backward kernels built in "
          f"{time.perf_counter() - t0:.1f} s")
    kernel = ""
    for line in deformable_cuda.build_log.splitlines():
        if "Function properties for" in line:   # the (mangled) kernel the next lines describe
            kernel = line.split(" for ", 1)[1].strip()
            kernel = kernel[kernel.rfind("ms_deform_attn_"):][:48]   # name and template args
        elif "registers" in line or "spill" in line:
            print(f"  ptxas: {kernel}: {line.strip()}")
    return card


def _inputs(levels, len_q, dtype, loc_set, gen, bs=BS, heads=HEADS):
    import torch
    from emrt_tpu_torch.models.deformable_transformer import _offset_bias_init
    from emrt_tpu_torch.models.position_encoding import encoder_reference_points
    dev = "cuda"
    len_v = sum(h * w for h, w in levels)
    n_lv = len(levels)
    value = torch.randn((bs, len_v, heads, HEAD_DIM), generator=gen, device=dev).to(dtype)
    attn = torch.randn((bs, len_q, heads, n_lv * POINTS), generator=gen, device=dev)
    attn = attn.softmax(-1).view(bs, len_q, heads, n_lv, POINTS).to(dtype)
    shape = (bs, len_q, heads, n_lv, POINTS, 2)
    if loc_set == "random":
        loc = torch.rand(shape, generator=gen, device=dev) * 1.2 - 0.1
    elif loc_set == "out of bounds":
        low = torch.rand(shape, generator=gen, device=dev) * 0.4 - 1.0   # [-1.0, -0.6)
        high = torch.rand(shape, generator=gen, device=dev) * 0.4 + 1.6  # [1.6, 2.0)
        loc = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.5, low, high)
    else:   # on the grid: encoder reference points + rotated-grid init offsets
        ref = encoder_reference_points(levels, device=dev)[:len_q]        # [Lq, L, 2]
        off = torch.from_numpy(_offset_bias_init(heads, n_lv, POINTS)).to(dev)
        norm = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32, device=dev)
        loc = (ref[:, None, :, None, :]
               + off.view(heads, n_lv, POINTS, 2) / norm[None, :, None, :])
        loc = loc.expand(shape).contiguous()
    return value, loc, attn


def _expect_raise(exc, fn, what):
    try:
        fn()
    except exc:
        return
    raise RuntimeError(f"check failed: {what} did not raise {exc.__name__}")


def _staging(plan):
    return f"{plan.staged} staged" if plan.staged else "none staged"


def _check_fwd(tag, value, levels, loc, attn, loc_set, plan=None):
    """K1 against the plain version: max |K1 - plain| within its bound;
    returns it."""
    import torch
    from emrt_tpu_torch.ops import deformable_cuda
    from emrt_tpu_torch.ops.deformable import deformable_attention_core
    dtype = value.dtype
    out = deformable_cuda.ms_deform_attn_fwd(value, levels, loc, attn, plan=plan)
    ref = deformable_attention_core(value, levels, loc, attn)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if loc_set == "out of bounds":
        tol = 0.0
        check(scale == 0.0, f"{tag} plain version not 0 out of bounds")
    elif dtype == torch.float32:
        tol = 1e-5 * scale + 1e-6
    else:
        tol = 1e-2 * scale
    check(out.shape == ref.shape and out.dtype == value.dtype,
          f"{tag} output {tuple(out.shape)} {out.dtype}")
    check(bool(torch.isfinite(out).all()), f"{tag} non-finite output")
    print(f"phase 1: {tag:21s} {str(dtype)[6:]:8s} {loc_set:13s} "
          f"max|K1-plain| {err:.3e} (tol {tol:.3e}, max|plain| {scale:.3e})")
    check(err <= tol, f"{tag} {dtype} {loc_set}: error {err} > {tol}")
    return err


def phase1():
    """K1 against its plain version at every SHAPES call (bs 32, and bs 8
    where the plan splits), at the TP ranks' head counts (TP_SHAPES, bs 32
    and 8), and the wrappers' refusals."""
    import torch
    from emrt_tpu_torch.ops import deformable_cuda
    from emrt_tpu_torch.ops.deformable import deformable_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, levels, len_q, bs, heads in [(*shape, BS, HEADS) for shape in SHAPES] + [
            ("encoder 256^2 bs 8", LEVELS_256, 1344, TRAIN_BS, HEADS),
            ("decoder 256^2 bs 8", LEVELS_256, 110, TRAIN_BS, HEADS)] + [
            (name if bs == BS else f"{name} bs 8", levels, len_q, bs, heads)
            for bs in (BS, TRAIN_BS) for name, levels, len_q, heads in TP_SHAPES]:
        for dtype in (torch.float32, torch.bfloat16):
            plan = deformable_cuda.fwd_plan(levels, HEAD_DIM, dtype, bs, heads, len_q, n_sms)
            print(f"phase 1: {name} bs {bs} {str(dtype)[6:]}: plan {plan}")
            plans = [None] if bs == BS else [None, deformable_cuda.fwd_plan(
                levels, HEAD_DIM, dtype, bs, heads, len_q, n_sms, stage=not plan.staged)]
            for loc_set in ("random", "out of bounds", "on the grid"):
                value, loc, attn = _inputs(levels, len_q, dtype, loc_set, gen, bs, heads)
                for other in plans:   # at bs 8 also with the other staging
                    tag = name if other is None else f"{name}, {_staging(other)}"
                    max_err = max(max_err, _check_fwd(tag, value, levels, loc, attn, loc_set,
                                                      other))

    # refusals that need a CUDA tensor (the device-free ones are CPU tests)
    value, loc, attn = _inputs(LEVELS_256, 110, torch.bfloat16, "random", gen)
    _expect_raise(ValueError, lambda: deformable_cuda.ms_deform_attn_fwd(
        value, LEVELS_256, loc.cpu(), attn), "a CPU loc beside CUDA value")
    _expect_raise(TypeError, lambda: deformable_cuda.ms_deform_attn_fwd(
        value, LEVELS_256, loc, attn.half()), "fp16 attention weights")
    _expect_raise(ValueError, lambda: deformable_cuda.ms_deform_attn_fwd(
        value, LEVELS_256, loc.transpose(1, 2).contiguous().transpose(1, 2), attn),
        "non-contiguous loc")
    _expect_raise(TypeError, lambda: deformable_cuda.ms_deform_attn_bwd(
        value, LEVELS_256, loc, attn, torch.zeros((BS, 110, 256), device="cuda")),
        "an f32 grad_out beside bf16 value")
    before = deformable_cuda.launches
    out = deformable_attention(value.float().requires_grad_(), LEVELS_256, loc, attn.float())
    check(type(out.grad_fn).__name__ == "DeformableAttentionFunctionBackward"
          and deformable_cuda.launches == before + 1,
          "a CUDA input that requires grad did not go through the Function and K1")
    print("phase 1: wrapper refusals OK; grad-requiring input through the Function")
    return max_err


def fwd_device_us(fn, reps: int = 20) -> float:
    """K1's device time per call of ``fn`` (torch.profiler over ``reps``
    calls, after one): the kernel's own time, without the host's. NaN where
    three profiles in a row recorded no K1 launch (the profiler now and then
    records no kernel at all)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                    if "ms_deform_attn_fwd" in e.key)
        if total > 0:
            return total / reps
    return float("nan")


def time_fwd():
    """Times of the whole ``ms_deform_attn_fwd`` (median of 10 CUDA-event
    calls) and of the plain version at every SHAPES call, at bs 32 and at the
    yamls' bs 8, in both dtypes, on random locations and on the grid, with
    its bytes' bound; and K1's device time (``fwd_device_us``) with the
    plan's own choices and with two others: where the plan splits or the
    (b, h) are fewer than the card's blocks, the other split (one block per
    (b, h) where the plan splits, two where it does not), and the other staging (none staged where
    the plan stages levels, the levels that fit where it stages none). The
    plan's choices are judged by device time: the decoder-sized calls are
    mostly host time, which the plan does not change. The TP ranks' calls
    (TP_SHAPES) are timed at bs 32.
    Returns {(name, bs, dtype): {"random": ms, ...}}."""
    import torch
    from emrt_tpu_torch.ops import deformable_cuda
    from emrt_tpu_torch.ops.deformable import deformable_attention_core
    gen = torch.Generator(device="cuda").manual_seed(5)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    ms = functools.partial(cuda_ms, reps=10, warmup=2)
    times = {}
    cases = [(bs, *shape, HEADS) for bs in (BS, TRAIN_BS) for shape in SHAPES]
    for bs, name, levels, len_q, heads in cases + [(BS, *shape) for shape in TP_SHAPES]:
        for dtype in (torch.float32, torch.bfloat16):
            plan = deformable_cuda.fwd_plan(levels, HEAD_DIM, dtype, bs, heads, len_q, n_sms)
            plans = {"plan": plan}
            if plan.splits > 1 or bs * heads < n_sms * plan.blocks_per_sm:
                split = 1 if plan.splits > 1 else 2
                plans[f"splits {split}"] = deformable_cuda.fwd_plan(
                    levels, HEAD_DIM, dtype, bs, heads, len_q, n_sms, splits=split)
            staging = deformable_cuda.fwd_plan(levels, HEAD_DIM, dtype, bs, heads, len_q,
                                               n_sms, stage=not plan.staged)
            plans[_staging(staging)] = staging
            t = {}
            for loc_set in ("on the grid", "random"):
                value, loc, attn = _inputs(levels, len_q, dtype, loc_set, gen, bs, heads)
                args = (value, levels, loc, attn)
                mine = functools.partial(deformable_cuda.ms_deform_attn_fwd, *args)
                t[loc_set] = ms(mine)
                for key, p in plans.items():
                    t[f"{loc_set}, {key} device"] = fwd_device_us(
                        functools.partial(mine, plan=p)) / 1e3
            t["plain"] = ms(lambda: deformable_attention_core(*args))
            line = ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
            # one FMA per channel and valid corner
            t["bound"] = bound([value, loc, attn, mine()],
                               2 * HEAD_DIM * _valid_corners(levels, loc))
            times[name, bs, dtype] = t
            print(f"time_fwd: {name:16s} {str(dtype)[6:]:8s} bs {bs:2d} K1 (median of 10, "
                  f"CUDA events; device: torch.profiler, 20 calls): {line}; bound "
                  f"{t['bound'][0]:.4f} ms ({t['bound'][1]}), "
                  f"{100 * t['bound'][0] / t['random']:.1f}% of it on random locations")
    return times


def phase2():
    import numpy as np
    import torch
    from emrt_tpu_torch.config import get_config
    from emrt_tpu_torch.data.datasets import SyntheticDataset
    from emrt_tpu_torch.inference import build_val_transforms, evaluate
    from emrt_tpu_torch.inference.slide import slide_inference, window_grid
    from emrt_tpu_torch.models import get_model
    from emrt_tpu_torch.ops import deformable_cuda

    cfg = get_config(str(CONFIG))
    cfg.DATA.DATASET = "Synthetic"
    cfg.TRAIN.DTYPE = "bfloat16"
    cfg.VAL.IMAGE_BASE_SIZE = IMAGE_SIZE
    cfg.VAL.STRIDE_SIZE = [171, 171]
    check(tuple(cfg.VAL.CROP_SIZE) == (256, 256), f"crop {cfg.VAL.CROP_SIZE}")
    dev = torch.device("cuda")
    torch.manual_seed(0)
    model = get_model(cfg, device=dev).eval()
    dataset = SyntheticDataset(build_val_transforms(cfg), num_samples=N_IMAGES,
                               crop_size=(IMAGE_SIZE, IMAGE_SIZE),
                               num_classes=cfg.DATA.NUM_CLASSES, mode="val", seed=0)
    n_win = len(window_grid(IMAGE_SIZE, IMAGE_SIZE, (256, 256), (171, 171)))
    finite = []      # one device flag per model forward

    def forward(images):
        logits = model(images)[0]
        check(tuple(logits.shape) == (images.shape[0], cfg.DATA.NUM_CLASSES)
              + tuple(images.shape[2:]), f"logits {tuple(logits.shape)}")
        finite.append(torch.isfinite(logits).all())
        return logits

    with torch.inference_mode():
        warm = torch.randn((WINDOW_BATCH, 3, 256, 256), device=dev)
        model(warm)                                   # cuDNN / allocator warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        deformable_cuda.launches = 0
        t0 = time.perf_counter()
        result = evaluate(forward, dataset, cfg, dev, window_batch=WINDOW_BATCH)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = deformable_cuda.launches
        calls = len(finite)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 2: evaluate over {N_IMAGES} images of {IMAGE_SIZE}^2 "
          f"({n_win} windows each): {calls} forwards, {launches} K1 launches, "
          f"mIoU {result['miou']:.4f}, {N_IMAGES * n_win / eval_s:.1f} windows/s "
          f"end to end incl. host data ({eval_s:.3f} s), peak memory {peak_gib:.2f} GiB")
    check(calls > 0 and launches == 6 * calls,
          f"K1 launches {launches} != 6 x {calls} forwards")
    check(all(bool(f) for f in finite), "non-finite logits in the slide run")
    check(0.0 <= result["miou"] <= 1.0, f"mIoU {result['miou']}")
    check(result["images"] == N_IMAGES, f"{result['images']} images evaluated")

    # the slide path alone on one device batch (no host data in the timing)
    bs = cfg.DATA.BATCH_SIZE_VAL
    imgs = torch.from_numpy(np.stack([dataset.get(i)[0] for i in range(bs)]))
    imgs = imgs.to(dev).permute(0, 3, 1, 2).contiguous()

    def slide():
        return slide_inference(lambda x: model(x)[0], imgs, (256, 256), (171, 171),
                               cfg.DATA.NUM_CLASSES, WINDOW_BATCH)

    with torch.inference_mode():
        slide_ms = cuda_ms(slide, reps=5, warmup=1)
    print(f"phase 2: slide_inference alone, bs {bs}: {slide_ms:.2f} ms, "
          f"{bs * n_win / slide_ms * 1e3:.1f} windows/s (median of 5, CUDA events)")

    # one window batch through K1 against the same weights through the plain core
    plain = get_model(cfg, device=dev, use_kernel=False).eval()
    plain.load_state_dict(model.state_dict())
    with torch.inference_mode():
        windows = torch.cat([imgs[:, :, h:h + 256, w:w + 256]
                             for h, w in window_grid(IMAGE_SIZE, IMAGE_SIZE, (256, 256),
                                                     (171, 171))[:WINDOW_BATCH // bs]])
        out_k = model(windows)[0]
        out_p = plain(windows)[0]
        profile_step(lambda: model(windows), f"phase 2: profile of one {windows.shape[0]}-"
                     f"window eval forward")
    err = (out_k - out_p).abs().max().item()
    scale = out_p.abs().max().item()
    print(f"phase 2: model logits K1 vs plain core on {windows.shape[0]} windows: "
          f"max abs diff {err:.4e}, max|logit| {scale:.4e} (tol {MODEL_RTOL} x max)")
    check(err <= MODEL_RTOL * scale, f"model logits differ by {err} > {MODEL_RTOL} x {scale}")
    return launches


def _plain_grads(value, levels, loc, attn, grad_out):
    """Autograd of the plain core: (grad value, grad loc, grad attn)."""
    import torch
    from emrt_tpu_torch.ops.deformable import deformable_attention_core
    ins = [t.detach().clone().requires_grad_() for t in (value, loc, attn)]
    out = deformable_attention_core(ins[0], levels, ins[1], ins[2])
    return torch.autograd.grad(out, ins, grad_out)


def _check_bwd(tag, value, levels, loc, attn, grad_out, loc_set):
    """The backward against the plain version's autograd: max |kernel - plain|
    per gradient, each within its bound; returns the largest error."""
    import torch
    from emrt_tpu_torch.ops import deformable_cuda
    dtype = value.dtype
    got = deformable_cuda.ms_deform_attn_bwd(value, levels, loc, attn, grad_out)
    want = _plain_grads(value, levels, loc, attn, grad_out)
    torch.cuda.synchronize()
    errs, max_err = [], 0.0
    for what, g, w, t in zip(("value", "loc", "attn"), got, want, (value, loc, attn)):
        check(g.shape == t.shape and g.dtype == w.dtype == t.dtype,
              f"{tag} grad {what} {tuple(g.shape)} {g.dtype}")
        check(bool(torch.isfinite(g).all()), f"{tag} non-finite grad {what}")
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        if loc_set == "out of bounds":
            tol = 0.0
            check(scale == 0.0, f"{tag} plain grad {what} not 0 out of bounds")
        elif dtype == torch.float32:
            tol = 1e-5 * scale + 1e-6
        else:
            tol = 1e-2 * scale
        check(err <= tol, f"{tag} {dtype} {loc_set} grad {what}: error {err} > {tol}")
        max_err = max(max_err, err)
        errs.append(f"{what} {err:.2e}/{scale:.2e}")
    print(f"phase 3a: {tag:21s} {str(dtype)[6:]:8s} {loc_set:13s} "
          f"max|kernel-plain| / max|plain|: {', '.join(errs)}")
    return max_err


def phase3a():
    """The fused backward against the plain version's autograd; its times."""
    import torch
    from emrt_tpu_torch.ops import deformable_cuda
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = 0.0
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    # bs 8 (the yamls' batch): 64 (b, h) on 132 SMs, so the plan splits them;
    # a TP rank's 4 or 2 heads split them more (bs 8 at 2 heads: 8 ways)
    for name, levels, len_q, bs, heads in [(*shape, BS, HEADS) for shape in SHAPES] + [
            ("encoder 256^2 bs 8", LEVELS_256, 1344, TRAIN_BS, HEADS)] + [
            (name if bs == BS else f"{name} bs 8", levels, len_q, bs, heads)
            for bs in (BS, TRAIN_BS) for name, levels, len_q, heads in TP_SHAPES]:
        plan = deformable_cuda.bwd_plan(levels, HEAD_DIM, bs, heads, len_q, n_sms)
        print(f"phase 3a: {name} bs {bs}: plan {plan}")
        for dtype in (torch.float32, torch.bfloat16):
            for loc_set in ("random", "out of bounds", "on the grid"):
                value, loc, attn = _inputs(levels, len_q, dtype, loc_set, gen, bs, heads)
                grad_out = torch.randn((bs, len_q, heads * HEAD_DIM), generator=gen,
                                       device="cuda").to(dtype)
                max_err = max(max_err, _check_bwd(name, value, levels, loc, attn, grad_out,
                                                  loc_set))
    return time_bwd(), max_err


def time_bwd(plain=True, other_split=True):
    """Times of the whole ``ms_deform_attn_bwd`` (any zero-fill and cast
    included; median of 10 CUDA-event calls) at every SHAPES call, at bs 32
    and at the yamls' bs 8, in both dtypes, on random locations and on the
    grid, with its bytes' bound; where asked, the plain autograd's time and,
    where the (b, h) are fewer than the SMs, the time with the other split
    (one block per (b, h) where the plan splits, two where it does not; the
    two timed in turns after one timing thrown away, each the mean of its
    two medians).
    Another commit's package that lacks the plan is timed with both off.
    The TP ranks' calls (TP_SHAPES) are timed at bs 32.
    Returns {(name, bs, dtype): {"random": ms, ...}}."""
    import torch
    from emrt_tpu_torch.ops import deformable_cuda
    from emrt_tpu_torch.ops.deformable import deformable_attention_core
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    ms = functools.partial(cuda_ms, reps=10, warmup=2)
    times = {}
    cases = [(bs, *shape, HEADS) for bs in (BS, TRAIN_BS) for shape in SHAPES]
    for bs, name, levels, len_q, heads in cases + [(BS, *shape) for shape in TP_SHAPES]:
        other = None
        if other_split and bs * heads < n_sms:
            plan = deformable_cuda.bwd_plan(levels, HEAD_DIM, bs, heads, len_q, n_sms)
            other = deformable_cuda.bwd_plan(levels, HEAD_DIM, bs, heads, len_q, n_sms,
                                             splits=1 if plan.splits > 1 else 2)
        for dtype in (torch.float32, torch.bfloat16):
            t = {}
            for loc_set in ("on the grid", "random"):
                value, loc, attn = _inputs(levels, len_q, dtype, loc_set, gen, bs, heads)
                grad_out = torch.randn((bs, len_q, heads * HEAD_DIM), generator=gen,
                                       device="cuda").to(dtype)
                args = (value, levels, loc, attn, grad_out)
                mine = functools.partial(deformable_cuda.ms_deform_attn_bwd, *args)
                if other is None:
                    t[loc_set] = ms(mine)
                else:   # in turns, after a timing thrown away: at the decoder calls
                    # the first timing after new inputs read up to 25% slow
                    theirs = functools.partial(mine, plan=other)
                    ms(mine)
                    a, b, c, d = ms(mine), ms(theirs), ms(theirs), ms(mine)
                    t[loc_set], t[f"{loc_set}, splits {other.splits}"] = (a + d) / 2, (b + c) / 2
            line = (f"random {t['random']:.4f} ms, on the grid {t['on the grid']:.4f} ms"
                    + "".join(f", {k} {v:.4f} ms" for k, v in t.items() if "splits" in k))
            if plain:
                ins = [x.clone().requires_grad_() for x in (value, loc, attn)]
                out = deformable_attention_core(ins[0], levels, ins[1], ins[2])
                t["plain"] = ms(lambda: torch.autograd.grad(out, ins, grad_out,
                                                            retain_graph=True))
                del out, ins
                line += f", plain {t['plain']:.4f} ms"
            # per channel and valid corner: an FMA into the dot product with
            # grad_out, and a product and an add into the value gradient
            t["bound"] = bound([*args[:1], *args[2:], *deformable_cuda.ms_deform_attn_bwd(
                *args)], 4 * HEAD_DIM * _valid_corners(levels, loc))
            times[name, bs, dtype] = t
            print(f"phase 3a: {name:16s} {str(dtype)[6:]:8s} bs {bs:2d} backward (median "
                  f"of 10, CUDA events): {line}; bound {t['bound'][0]:.4f} ms "
                  f"({t['bound'][1]}), {100 * t['bound'][0] / t['random']:.1f}% of it "
                  f"on random locations")
    return times


def _train_config():
    from emrt_tpu_torch.config import get_config
    cfg = get_config(str(CONFIG))
    cfg.DATA.DATASET = "Synthetic"
    cfg.TRAIN.DTYPE = "bfloat16"
    return cfg


def _set_kernel_and_dropout(model, use_kernel=None, dropout=None):
    import torch
    from emrt_tpu_torch.models import MSDeformableAttention
    for m in model.modules():
        if use_kernel is not None and isinstance(m, MSDeformableAttention):
            m.use_kernel = use_kernel
        if dropout is not None and isinstance(m, torch.nn.Dropout):
            m.p = dropout


def _model_grads(model, images, labels, loss_fn, use_kernel, dtype, train_bn):
    """One forward and backward of ``model`` (dropout 0) with the deformable
    core through the kernels or the plain version, computing in ``dtype``,
    BatchNorm on batch statistics (``train_bn``) or frozen; returns (loss,
    all gradients flat)."""
    import torch
    _set_kernel_and_dropout(model, use_kernel=use_kernel)
    model.train(train_bn)
    model.dtype = dtype
    model.zero_grad(set_to_none=True)
    before = _counts()
    loss = loss_fn(list(model(images)), labels)
    loss.backward()
    torch.cuda.synchronize()
    delta = [c1 - c0 for c0, c1 in zip(before, _counts())]
    check(delta == ([6, 6] if use_kernel else [0, 0]),
          f"use_kernel={use_kernel}: forward/backward launches {delta}")
    # a parameter no path reads (CSwin's and ViT's tap-0 LayerNorm) has no grad
    grads = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).flatten()
                       for p in model.parameters()])
    check(bool(torch.isfinite(grads).all()),
          f"non-finite gradients (use_kernel={use_kernel}, {dtype})")
    return loss.item(), grads


def phase3b():
    """The full-width model's loss and gradients through the kernels against the
    same weights through the plain core (batch 8, dropout 0)."""
    import torch
    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.models import get_model
    cfg = _train_config()
    torch.manual_seed(0)
    model = get_model(cfg, device="cuda")
    _set_kernel_and_dropout(model, dropout=0.0)
    loss_fn = get_loss_function(cfg)
    gen = torch.Generator(device="cuda").manual_seed(2)
    images = torch.randn((TRAIN_BS, 3, 256, 256), generator=gen, device="cuda")
    labels = torch.randint(0, cfg.DATA.NUM_CLASSES, (TRAIN_BS, 256, 256), generator=gen,
                           device="cuda")
    # (BatchNorm on batch statistics, dtype) -> (loss rtol, gradient rtol)
    cases = {(False, torch.float32): (1e-6, F32_GRAD_RTOL),
             (False, torch.bfloat16): (LOSS_RTOL, MODEL_RTOL),
             (True, torch.bfloat16): (LOSS_RTOL, TRAIN_BN_GRAD_RTOL)}
    for (train_bn, dtype), (loss_rtol, grad_rtol) in cases.items():
        loss_k, grads_k = _model_grads(model, images, labels, loss_fn, True, dtype, train_bn)
        loss_p, grads_p = _model_grads(model, images, labels, loss_fn, False, dtype, train_bn)
        rel = ((grads_k - grads_p).norm() / grads_p.norm()).item()
        print(f"phase 3b: full-width EMRT-R50 {str(dtype)[6:]} bs {TRAIN_BS}, BatchNorm "
              f"{'on batch statistics' if train_bn else 'frozen'}: loss kernels "
              f"{loss_k:.7f} plain {loss_p:.7f}; all gradients |k-p|/|p| (L2) {rel:.3e} "
              f"(tol {grad_rtol})")
        check(abs(loss_k - loss_p) <= loss_rtol * abs(loss_p),
              f"loss through the kernels {loss_k} vs plain {loss_p}")
        check(rel <= grad_rtol, f"gradients differ by {rel} > {grad_rtol} (L2)")
    model.dtype = torch.bfloat16


def phase3c(card, save_dir):
    """The trainer through its entry point, saving into ``save_dir``; train
    step times and profile."""
    import numpy as np
    import torch
    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.models import get_model
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import main as train_main
    from emrt_tpu_torch.train import make_train_step

    common = ["--config", str(CONFIG), "--device", "cuda", "--seed", "0",
              "DATA.DATASET", "Synthetic", "DATA.BATCH_SIZE", str(TRAIN_BS),
              "TRAIN.DTYPE", "bfloat16", "SAVE_DIR", save_dir,
              "LOGGING_INFO_FREQ", "5", "SAVE_FREQ_CHECKPOINT", str(TRAIN_ITERS),
              "VALIDATE_FREQ", str(TRAIN_ITERS)]
    _reset_counts()
    t0 = time.perf_counter()
    first = train_main(["--iters", str(TRAIN_ITERS), *common])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = _counts()
    steps, forwards = first["steps"], first["eval_forwards"] + FLOPS_FORWARDS
    print(f"phase 3c: train.main {TRAIN_ITERS} iters at bs {TRAIN_BS} with one save "
          f"and one eval ({forwards} eval and FLOPs forwards) in {train_s:.1f} s; window "
          f"losses {[round(x, 4) for x in first['losses']]}, mIoU {first['mious']}; "
          f"launches forward {launches[0]}, backward {launches[1]}")
    check(steps == TRAIN_ITERS and first["last_iter"] == TRAIN_ITERS,
          f"ran {steps} steps to iter {first['last_iter']}")
    check(len(first["losses"]) > 0 and all(np.isfinite(first["losses"])),
          f"losses {first['losses']}")
    check(len(first["mious"]) == 1 and 0.0 <= first["mious"][0] <= 1.0,
          f"mIoU {first['mious']}")
    check(launches == (6 * (steps + forwards), 6 * steps),
          f"launches {launches} for {steps} steps and {forwards} eval and FLOPs forwards")
    ckpt = Path(save_dir) / "checkpoints" / f"iter_{TRAIN_ITERS}.pt"
    check(ckpt.exists() and (Path(save_dir) / "best_model.pt").exists(),
          f"no checkpoint at {ckpt}")
    resumed = train_main(["--iters", str(RESUME_ITERS), "--resume", *common])
    check(resumed["start_iter"] == TRAIN_ITERS and resumed["last_iter"] == RESUME_ITERS
          and resumed["steps"] == RESUME_ITERS - TRAIN_ITERS,
          f"--resume ran {resumed['start_iter']} -> {resumed['last_iter']}")
    check(all(np.isfinite(resumed["losses"])), f"losses {resumed['losses']}")
    print(f"phase 3c: --resume continued at iter {resumed['start_iter']} to "
          f"{resumed['last_iter']}, losses {[round(x, 4) for x in resumed['losses']]}")

    rows = time_train_steps(card, (TRAIN_BS, BS), reps=10)
    return launches, rows


def time_train_steps(card, sizes, reps, what="phase 3c"):
    """One process's bf16 train step of the flagship (seeded weights,
    dropout as the yaml sets it) on device batches, host data left out: for
    each batch size of ``sizes`` the median of ``reps`` steps (CUDA events)
    and the peak memory; then the profile of a step at the last size.
    Returns {bs: (ms, tiles/s, peak GiB)}."""
    import torch
    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.models import get_model
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import make_train_step
    cfg = _train_config()
    torch.manual_seed(0)
    model = get_model(cfg, device="cuda")
    schedule = get_scheduler(cfg)
    step = make_train_step(model, get_loss_function(cfg),
                           get_optimizer(cfg, model, schedule))
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for bs in sizes:
        batch = {"image": torch.randn((bs, 3, 256, 256), generator=gen, device="cuda"),
                 "label": torch.randint(0, cfg.DATA.NUM_CLASSES, (bs, 256, 256),
                                        generator=gen, device="cuda")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(batch), reps=reps, warmup=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rows[bs] = (ms, bs / ms * 1e3, peak)
        print(f"{what}: train step bs {bs} bf16 256^2: {ms:.2f} ms, "
              f"{bs / ms * 1e3:.1f} tiles/s, peak memory {peak:.2f} GiB "
              f"(median of {reps}, CUDA events; {card})")
    profile_step(lambda: step(batch), f"{what}: profile of one bs-{sizes[-1]} step")
    del model, step
    torch.cuda.empty_cache()
    return rows


VARIANT_YAMLS = ("cswin", "vit", "hrnet", "segformer")   # EMRT_256x256_160k_potsdam_{v}.yaml
# (name, config overrides, the encoder's levels at a 256^2 input)
OTHER_BACKBONES = (("ResNeXt50", {"MODEL.ENCODER.TYPE": "resnext50"}, LEVELS_256),
                   ("ResNeSt50", {"MODEL.ENCODER.TYPE": "resnest50"}, LEVELS_256),
                   ("resnet50c", {"MODEL.ENCODER.TYPE": "resnet50c"}, LEVELS_256),
                   ("resnet50 OS16", {"MODEL.OUTPUT_STRIDE": 16}, LEVELS_OS16),
                   ("resnet50 OS8", {"MODEL.OUTPUT_STRIDE": 8}, LEVELS_32X3))
# ResNet-50 yamls at other crops: (yaml, the encoder's levels at its crop)
CROP_YAMLS = (("EMRT_224x224_160k_potsdam.yaml", LEVELS_224),
              ("EMRT_384x384_160k_potsdam.yaml", LEVELS_384),
              ("EMRT_448x448_160k_potsdam.yaml", LEVELS_448))
VARIANT_IMAGES, VARIANT_STEPS = 2, 3


def _variant_config(path, overrides=()):
    from emrt_tpu_torch.config import get_config
    cfg = get_config(str(path))
    cfg.DATA.DATASET = "Synthetic"
    cfg.TRAIN.DTYPE = "bfloat16"
    cfg.merge_from_list([str(v) for kv in overrides for v in kv])
    return cfg


def _train_steps(model, cfg, n, gen):
    """n train steps at TRAIN_BS on device batches of the config's crop;
    checks each launched the forward and the backward kernel six times and
    that the losses are finite."""
    import numpy as np
    import torch
    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import make_train_step
    step = make_train_step(model, get_loss_function(cfg),
                           get_optimizer(cfg, model, get_scheduler(cfg)))
    size = tuple(cfg.DATA.CROP_SIZE)
    batch = {"image": torch.randn((TRAIN_BS, 3, *size), generator=gen, device="cuda"),
             "label": torch.randint(0, cfg.DATA.NUM_CLASSES, (TRAIN_BS, *size),
                                    generator=gen, device="cuda")}
    _reset_counts()
    losses = torch.stack([step(batch) for _ in range(n)]).tolist()
    launches = _counts()
    check(launches == (6 * n,) * 2, f"{n} train steps launched forward/backward {launches}")
    check(all(np.isfinite(losses)), f"train losses {losses}")
    return step, batch, losses, launches


def phase4_variant(variant, card):
    """One variant yaml: evaluate, train steps, kernels against the plain core."""
    import torch
    from emrt_tpu_torch.data.datasets import SyntheticDataset
    from emrt_tpu_torch.inference import build_val_transforms, evaluate
    from emrt_tpu_torch.inference.slide import window_grid
    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.models import get_model
    path = CONFIG.with_name(f"EMRT_256x256_160k_potsdam_{variant}.yaml")
    cfg = _variant_config(path)
    stride = tuple(cfg.VAL.STRIDE_SIZE)
    cfg.VAL.IMAGE_BASE_SIZE = IMAGE_SIZE
    cfg.VAL.STRIDE_SIZE = [171, 171]
    torch.manual_seed(0)
    with torch.device("cuda"):
        model = get_model(cfg).eval()
    n_params = sum(p.numel() for p in model.parameters())
    tag = f"phase 4: {path.name} ({model.variant}, {n_params / 1e6:.1f}M params)"
    dataset = SyntheticDataset(build_val_transforms(cfg), num_samples=VARIANT_IMAGES,
                               crop_size=(IMAGE_SIZE, IMAGE_SIZE),
                               num_classes=cfg.DATA.NUM_CLASSES, mode="val", seed=0)
    n_win = len(window_grid(IMAGE_SIZE, IMAGE_SIZE, (256, 256), (171, 171)))
    finite, n_windows = [], []

    def forward(images):
        logits = model(images)[0]
        finite.append(torch.isfinite(logits).all())
        n_windows.append(images.shape[0])
        return logits

    with torch.inference_mode():
        model(torch.randn((WINDOW_BATCH, 3, 256, 256), device="cuda"))   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        evaluate(forward, dataset, cfg, "cuda", window_batch=WINDOW_BATCH)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = _counts()[0]
        eval_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    windows_s = sum(n_windows) / eval_s
    print(f"{tag}: evaluate over {VARIANT_IMAGES} images of {IMAGE_SIZE}^2 ({n_win} windows "
          f"each) at stride 171 (the yaml's {list(stride)} leaves pixels no window covers, "
          f"F5): {len(finite)} forwards of {sum(n_windows)} windows (the val batch of "
          f"{cfg.DATA.BATCH_SIZE_VAL} padded with copies), {launches} K1 launches, "
          f"{windows_s:.1f} windows/s end to end incl. host data, peak memory "
          f"{eval_gib:.2f} GiB ({card})")
    check(len(finite) > 0 and launches == 6 * len(finite),
          f"{variant}: K1 launches {launches} != 6 x {len(finite)} forwards")
    check(all(bool(f) for f in finite), f"{variant}: non-finite logits")

    with torch.device("cuda"):
        plain = get_model(cfg, use_kernel=False).eval()
    plain.load_state_dict(model.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.inference_mode():
        windows = torch.randn((WINDOW_BATCH, 3, 256, 256), generator=gen, device="cuda")
        out_k, out_p = model(windows)[0], plain(windows)[0]
    err, scale = (out_k - out_p).abs().max().item(), out_p.abs().max().item()
    print(f"{tag}: logits K1 vs plain core on {WINDOW_BATCH} windows: max abs diff "
          f"{err:.4e}, max|logit| {scale:.4e} (tol {MODEL_RTOL} x max)")
    check(err <= MODEL_RTOL * scale, f"{variant}: logits differ by {err} > {MODEL_RTOL} x {scale}")
    del plain

    # on the seeded weights, before any step, as phase 3b
    images = torch.randn((TRAIN_BS, 3, 256, 256), generator=gen, device="cuda")
    labels = torch.randint(0, cfg.DATA.NUM_CLASSES, (TRAIN_BS, 256, 256), generator=gen,
                           device="cuda")
    loss_fn = get_loss_function(cfg)
    loss_k, grads_k = _model_grads(model, images, labels, loss_fn, True, torch.float32, False)
    loss_p, grads_p = _model_grads(model, images, labels, loss_fn, False, torch.float32, False)
    rel = ((grads_k - grads_p).norm() / grads_p.norm()).item()
    print(f"{tag}: float32 bs {TRAIN_BS}, BatchNorm frozen: loss kernels {loss_k:.7f} plain "
          f"{loss_p:.7f}; all gradients |k-p|/|p| (L2) {rel:.3e} (tol {F32_GRAD_RTOL})")
    check(abs(loss_k - loss_p) <= 1e-6 * abs(loss_p),
          f"{variant}: loss through the kernels {loss_k} vs plain {loss_p}")
    check(rel <= F32_GRAD_RTOL, f"{variant}: gradients differ by {rel} > {F32_GRAD_RTOL}")
    model.dtype = torch.bfloat16
    model.zero_grad(set_to_none=True)
    _set_kernel_and_dropout(model, use_kernel=True)
    del grads_k, grads_p

    step, batch, losses, train_launches = _train_steps(model, cfg, VARIANT_STEPS, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(batch), reps=5, warmup=1)
    train_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{tag}: {VARIANT_STEPS} train steps at bs {TRAIN_BS}, losses "
          f"{[round(x, 4) for x in losses]}, launches forward/backward {train_launches}; "
          f"train step "
          f"bs {TRAIN_BS} bf16 256^2: {step_ms:.2f} ms (median of 5, CUDA events), peak "
          f"memory {train_gib:.2f} GiB ({card})")

    del model, step
    torch.cuda.empty_cache()
    return {"windows_s": windows_s, "step_ms": step_ms, "eval_gib": eval_gib,
            "train_gib": train_gib,
            "launches": (launches + train_launches[0], *train_launches[1:])}


def phase4_backbone(name, overrides, levels, path=CONFIG):
    """One full-width bf16 forward and one train step of a CNN backbone, at
    the crop of the yaml at ``path``."""
    import torch
    from emrt_tpu_torch.models import get_model
    cfg = _variant_config(path, overrides.items())
    size = tuple(cfg.DATA.CROP_SIZE)
    torch.manual_seed(0)
    with torch.device("cuda"):
        model = get_model(cfg).eval()
    gen = torch.Generator(device="cuda").manual_seed(5)
    images = torch.randn((TRAIN_BS, 3, *size), generator=gen, device="cuda")
    with torch.inference_mode():
        got = tuple(tuple(m.shape[2:]) for m in model._backbone_features(images[:1])[0])
        check(got == levels, f"{name}: encoder levels {got}, expected {levels}")
        _reset_counts()
        main, aux = model(images)
    launches = _counts()[0]
    check(launches == 6, f"{name}: one forward launched K1 {launches} times")
    check(tuple(main.shape) == (TRAIN_BS, cfg.DATA.NUM_CLASSES, *size)
          and bool(torch.isfinite(main).all() and torch.isfinite(aux).all()),
          f"{name}: logits {tuple(main.shape)} not finite")
    _, _, losses, train_launches = _train_steps(model, cfg, 1, gen)
    print(f"phase 4: {name}: {size[0]}^2, encoder levels {levels}; forward bs {TRAIN_BS} (K1 "
          f"x{launches}) and one train step (loss {losses[0]:.4f}, forward/backward "
          f"{train_launches})")
    del model
    torch.cuda.empty_cache()
    return (launches + train_launches[0], *train_launches[1:])


def phase4_trainer(variant):
    """The trainer's entry point for 4 iterations on a variant yaml."""
    import tempfile

    import numpy as np
    import torch
    from emrt_tpu_torch.train import main as train_main
    path = CONFIG.with_name(f"EMRT_256x256_160k_potsdam_{variant}.yaml")
    iters = 4
    with tempfile.TemporaryDirectory() as save_dir:
        _reset_counts()
        t0 = time.perf_counter()
        out = train_main(["--config", str(path), "--device", "cuda", "--seed", "0",
                          "--iters", str(iters), "DATA.DATASET", "Synthetic",
                          "DATA.BATCH_SIZE", str(TRAIN_BS), "TRAIN.DTYPE", "bfloat16",
                          "SAVE_DIR", save_dir, "LOGGING_INFO_FREQ", "2"])
        torch.cuda.synchronize()
        launches = _counts()
    steps, forwards = out["steps"], out["eval_forwards"] + FLOPS_FORWARDS
    print(f"phase 4: train.main {iters} iters on {path.name} at bs {TRAIN_BS} in "
          f"{time.perf_counter() - t0:.1f} s: window losses "
          f"{[round(x, 4) for x in out['losses']]}, mIoU {out['mious']}, {forwards} eval "
          f"and FLOPs forwards; launches forward/backward {launches}")
    check(steps == iters and out["last_iter"] == iters, f"ran {steps} steps")
    check(len(out["losses"]) > 0 and all(np.isfinite(out["losses"])), f"losses {out['losses']}")
    check(launches == (6 * (steps + forwards), 6 * steps),
          f"launches {launches} for {steps} steps and {forwards} eval forwards")
    return launches


def phase4(card):
    """Returns (per-variant rows, forward/backward launches summed over phase 4's
    paths)."""
    rows = {v: phase4_variant(v, card) for v in VARIANT_YAMLS}
    counts = [r["launches"] for r in rows.values()]
    counts += [phase4_backbone(*b) for b in OTHER_BACKBONES]
    counts += [phase4_backbone(y, {}, levels, CONFIG.with_name(y)) for y, levels in CROP_YAMLS]
    counts += [phase4_trainer(v) for v in ("vit", "hrnet")]
    print(f"phase 4: per variant (bf16 256^2 windows, seeded random weights; {card}):")
    for v, r in rows.items():
        print(f"  {v:10s} evaluate {r['windows_s']:8.1f} windows/s (peak {r['eval_gib']:.2f} "
              f"GiB), train step bs {TRAIN_BS} {r['step_ms']:8.2f} ms (peak "
              f"{r['train_gib']:.2f} GiB)")
    return rows, [sum(c[i] for c in counts) for i in range(2)]


# phase 5: the TTA agreement bound (share of pixels whose prediction through
# K1 equals the plain core's), the mixed-shape images, and the F6 bound on
# the mIoU of best_model.pt against the training run's evaluation of it
AGREEMENT, MIXED_SHAPES, F6_MIOU_TOL = 0.99, ((1000, 800), (900, 1100), (768, 768)), 1e-3


class _MixedImages:
    """A val dataset of seeded random normalized images of ``shapes`` with
    random labels, read as the package's datasets are (``get``)."""

    def __init__(self, shapes, num_classes, seed):
        import numpy as np
        rng = np.random.default_rng(seed)
        self.items = [(rng.standard_normal((h, w, 3)).astype(np.float32),
                       rng.integers(0, num_classes, (h, w)).astype(np.int32))
                      for h, w in shapes]

    def __len__(self):
        return len(self.items)

    def get(self, i, rng=None):
        return self.items[i]


def _eval_through_kernels(model, dataset, cfg, multi_scales, tag):
    """``evaluate`` through K1 (window batch 32, no progress bar), timed end
    to end; checks 6 K1 launches per model forward and mIoU in [0, 1].
    Returns (result, seconds, peak GiB, K1 launches)."""
    import torch
    from emrt_tpu_torch.inference import evaluate
    forwards = []

    def forward(images):
        forwards.append(images.shape[0])
        return model(images)[0]

    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        result = evaluate(forward, dataset, cfg, "cuda", multi_scales=multi_scales,
                          window_batch=WINDOW_BATCH, progbar=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _counts()[0]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(forwards and launches == 6 * len(forwards),
          f"{tag}: K1 launches {launches} != 6 x {len(forwards)} forwards")
    check(0.0 <= result["miou"] <= 1.0 and result["images"] == len(dataset),
          f"{tag}: mIoU {result['miou']} over {result['images']} images")
    print(f"phase 5: {tag}: {result['images']} images in {secs:.3f} s end to end incl. host "
          f"data, {result['images'] / secs:.3f} images/s, {len(forwards)} forwards of "
          f"{sum(forwards)} windows, {launches} K1 launches, mIoU {result['miou']:.4f}, "
          f"peak memory {peak:.2f} GiB")
    return result, secs, peak, launches


def _agreement(tag, pred_k, pred_p, valid=None):
    """Share of pixels where the predictions through K1 and through the plain
    core agree; checks it is at least AGREEMENT."""
    same = pred_k == pred_p
    share = (same if valid is None else same[valid]).float().mean().item()
    print(f"phase 5: {tag}: predictions through K1 and through the plain core agree on "
          f"{100 * share:.4f}% of pixels (bound {100 * AGREEMENT:.0f}%)")
    check(share >= AGREEMENT, f"{tag}: agreement {share} < {AGREEMENT}")
    return share


def phase5_tta(model, plain, cfg, n_images, size, stride):
    """Multi-scale + flip TTA through ``evaluate`` over ``n_images``
    synthetic images of ``size``^2 at ``stride``; the predictions of the
    first val batch through K1 against the plain core's."""
    import numpy as np
    import torch
    from emrt_tpu_torch.data.datasets import SyntheticDataset
    from emrt_tpu_torch.inference import build_val_transforms, ms_inference
    cfg = cfg.clone()
    cfg.VAL.IMAGE_BASE_SIZE = size
    cfg.VAL.STRIDE_SIZE = list(stride)
    crop = tuple(cfg.VAL.CROP_SIZE)
    tag = (f"TTA at {size}^2, crop {crop[0]}, stride {stride[0]}, scales "
           f"{list(cfg.VAL.SCALE_RATIOS)} x (as is, flipped)")
    dataset = SyntheticDataset(build_val_transforms(cfg), num_samples=n_images,
                               crop_size=(size, size), num_classes=cfg.DATA.NUM_CLASSES,
                               mode="val", seed=1)
    _, secs, peak, launches = _eval_through_kernels(model, dataset, cfg, True, tag)
    n = min(n_images, cfg.DATA.BATCH_SIZE_VAL)
    imgs = torch.from_numpy(np.stack([dataset.get(i)[0] for i in range(n)]))
    imgs = imgs.to("cuda").permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        k, p = (ms_inference(lambda x, m=m: m(x)[0], imgs, (size, size), stride, crop,
                             cfg.DATA.NUM_CLASSES, WINDOW_BATCH,
                             scales=cfg.VAL.SCALE_RATIOS, flip_horizontal=True)
                for m in (model, plain))
    share = _agreement(f"{tag}, {n} images", k, p)
    return {"images_s": n_images / secs, "peak_gib": peak, "launches": launches,
            "agreement": share}


def phase5_mixed(model, plain, cfg):
    """``evaluate`` over one val batch of MIXED_SHAPES (the variable-shape
    path, single scale, stride 171); its predictions through K1 against the
    plain core's where the labels count."""
    import torch
    from emrt_tpu_torch.inference.evaluate import _variable_shape_predict
    cfg = cfg.clone()
    cfg.VAL.IMAGE_BASE_SIZE = None
    cfg.VAL.STRIDE_SIZE = [171, 171]
    C, ignore = cfg.DATA.NUM_CLASSES, cfg.TRAIN.IGNORE_INDEX
    dataset = _MixedImages(MIXED_SHAPES, C, seed=2)
    tag = f"variable-shape eval of {list(MIXED_SHAPES)}, crop 256, stride 171"
    _, secs, peak, launches = _eval_through_kernels(model, dataset, cfg, False, tag)
    imgs, labels = zip(*dataset.items)
    with torch.inference_mode():
        (k, lab), (p, _) = (_variable_shape_predict(
            lambda x, m=m: m(x)[0], list(imgs), list(labels), cfg, False,
            tuple(cfg.VAL.CROP_SIZE), (171, 171), C, ignore, WINDOW_BATCH, "cuda")
            for m in (model, plain))
    share = _agreement(tag, k, p, lab != ignore)
    return {"images_s": len(dataset) / secs, "peak_gib": peak, "launches": launches,
            "agreement": share}


def phase5_checkpoints(save_dir, num_classes):
    """F6 on the card: ``val.main`` on phase 3c's best_model.pt gives the
    best mIoU its training run evaluated (within F6_MIOU_TOL), and
    ``predict.main`` on its latest iter_<n>.pt writes one PNG per image, of
    the image's size, in palette colours only. Returns (K1 launches,
    predict images/s)."""
    import json
    import tempfile

    import cv2
    import numpy as np
    from emrt_tpu_torch.predict import main as predict_main
    from emrt_tpu_torch.utils.checkpoint import CheckpointManager
    from emrt_tpu_torch.utils.flops import format_cost
    from emrt_tpu_torch.utils.vis import get_palette
    from emrt_tpu_torch.val import main as val_main
    save_dir = Path(save_dir)
    common = ["--config", str(CONFIG), "--device", "cuda", "DATA.DATASET", "Synthetic",
              "TRAIN.DTYPE", "bfloat16", "DATA.BATCH_SIZE", str(TRAIN_BS)]
    best = json.loads((save_dir / "best_model.json").read_text())["best_miou"]
    _reset_counts()
    result = val_main([*common, "--model_path", str(save_dir / "best_model.pt")])
    val_launches = _counts()[0]
    print(f"phase 5: val.main on best_model.pt: mIoU {result['miou']:.6f} against the "
          f"training run's {best:.6f}; {result['forwards']} forwards and the FLOPs count's "
          f"one, {val_launches} K1 launches; {format_cost(result['cost'])}")
    check(abs(result["miou"] - best) <= F6_MIOU_TOL,
          f"best_model.pt evaluates to mIoU {result['miou']}, the training run's {best}")
    check(val_launches == 6 * (result["forwards"] + 1),
          f"val.main: K1 launches {val_launches} for {result['forwards']} + 1 forwards")

    ckpt = CheckpointManager(str(save_dir))
    path = ckpt.path(ckpt.latest_step())
    palette = {tuple(c) for c in get_palette("Synthetic")[:num_classes]}
    with tempfile.TemporaryDirectory() as out_dir:
        _reset_counts()
        t0 = time.perf_counter()
        out = predict_main([*common, "--model_path", path, "--out_dir", out_dir])
        secs = time.perf_counter() - t0
        pred_launches = _counts()[0]
        for f in out["files"]:
            img = cv2.imread(f, cv2.IMREAD_COLOR)
            check(img is not None and img.shape == (256, 256, 3), f"{f}: {img is not None}")
            colours = {tuple(c) for c in np.unique(img[..., ::-1].reshape(-1, 3), axis=0)}
            check(colours <= palette, f"{f}: colours {sorted(colours - palette)[:3]} "
                                      f"outside the palette")
    n = len(out["files"])
    print(f"phase 5: predict.main on {Path(path).name}: {n} PNGs of 256^2 in palette "
          f"colours, {out['forwards']} forwards, {pred_launches} K1 launches, {secs:.3f} s, "
          f"{n / secs:.3f} images/s incl. model build and PNG writes")
    check(n == 64 and pred_launches == 6 * out["forwards"],
          f"predict.main: {n} files, K1 launches {pred_launches} for {out['forwards']} forwards")
    return val_launches + pred_launches, n / secs


def phase5(card, save_dir):
    """The inference surface on the flagship yaml at full width and depth,
    bf16, seeded weights: TTA at the yaml's geometry and at phase 2's, the
    variable-shape eval, and val / predict from phase 3c's checkpoints.
    Returns {row: numbers} and phase 5's K1 launches."""
    import torch
    from emrt_tpu_torch.models import get_model
    cfg = _train_config()
    torch.manual_seed(0)
    model = get_model(cfg, device="cuda").eval()
    plain = get_model(cfg, device="cuda", use_kernel=False).eval()
    plain.load_state_dict(model.state_dict())
    rows = {"tta 256": phase5_tta(model, plain, cfg, N_IMAGES, 256,
                                  tuple(cfg.VAL.STRIDE_SIZE)),
            "tta 1024": phase5_tta(model, plain, cfg, 2, IMAGE_SIZE, (171, 171)),
            "mixed": phase5_mixed(model, plain, cfg)}
    del model, plain
    torch.cuda.empty_cache()
    launches, predict_s = phase5_checkpoints(save_dir, cfg.DATA.NUM_CLASSES)
    rows["predict"] = {"images_s": predict_s}
    launches += sum(r["launches"] for r in rows.values() if "launches" in r)
    print(f"phase 5 ({card}): " + "; ".join(
        f"{k} {r['images_s']:.3f} images/s" + (f", peak {r['peak_gib']:.2f} GiB"
                                               if "peak_gib" in r else "")
        for k, r in rows.items()) + f"; {launches} K1 launches in all")
    return rows, launches


# phase 6: the model zoo on the card. Each yaml's model at full width and
# depth with seeded random weights, in the order of ``ZOO_YAMLS``; the
# crop-size window batch of its evaluate; the f32 card-vs-CPU bound
ZOO_YAMLS = ("setr/SETR_PUP_Large_256x256_160k_potsdam_bs_8.yaml",
             "setr/SETR_Naive_Large_256x256_160k_potsdam_bs_8.yaml",
             "setr/SETR_MLA_Large_512x512_160k_ade20k_bs_8.yaml",
             "upernet_swin/upernet_swin_tiny_patch4_windown7_512x512_160k_potsdam.yaml",
             "upernet_cswin/upernet_cswin_tiny_patch4_512x512_160k_potsdam.yaml",
             "upernet_focal/upernet_focal_base_patch4_windown7_512x512_160k_potsdam.yaml",
             "dpt/DPT_Large_512x512_160k_potsdam_bs_8.yaml",
             "trans2seg/Trans2Seg_medium_256x256_160k_potsdam.yaml",
             "segformer/segformer_b5_512x512_160k_ade20k.yaml",
             "segmenter/segmenter_Large_512x512_160k_ade20k_bs_16.yaml",
             "segmenter/segmenter_base_distilled_512x512_160k_ade20k_bs_16.yaml",
             "segmenter/segmenter_base_distilled_linear_512x512_160k_ade20k_bs_16.yaml")
# (yaml, optimizer class it must build): the AdamW and Adam yamls, 2 steps each
ZOO_OPTIMIZER_YAMLS = (("upernet_swin/upernet_swin_tiny_512x512_160k_ade20k.yaml", "AdamW"),
                       ("trans2seg/Trans2Seg_medium_512x512_80k_trans10kv2.yaml", "Adam"))
ZOO_WINDOWS = {256: 36, 512: 16}         # one 1024^2 image at stride 171, one chunk or two
# one float32 window on the card (TF32 off) against the same model on the CPU:
# both sum in float32 in another order, through up to 24 transformer layers
ZOO_F32_RTOL = 1e-3
# train steps a model: the first ZOO_WARMUP (cuDNN's and the allocator's first
# shapes) are left out of the median
ZOO_STEPS, ZOO_WARMUP, ZOO_TRAINER_ITERS = 6, 2, 4


def _zoo_config(yaml, overrides=()):
    return _variant_config(ROOT / "configs" / yaml, overrides)


def phase6_model(yaml, card):
    """One zoo yaml at full width: f32 card vs CPU, a bf16 evaluate of one
    1024^2 image at stride 171, six bf16 train steps at the yaml's batch
    with its optimizer (timed), and one profiled step."""
    import copy

    import numpy as np
    import torch
    from emrt_tpu_torch.data.datasets import SyntheticDataset
    from emrt_tpu_torch.inference import build_val_transforms, evaluate
    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.models import get_model
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import make_train_step
    cfg = _zoo_config(yaml)
    crop = tuple(cfg.DATA.CROP_SIZE)
    torch.manual_seed(0)
    t0 = time.perf_counter()
    with torch.device("cuda"):
        model = get_model(cfg).eval()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    tag = f"phase 6: {Path(yaml).stem} ({type(model).__name__}, {n_params / 1e6:.1f}M params)"

    # float32, one window at the yaml's crop: the card against the CPU
    gen = torch.Generator(device="cuda").manual_seed(6)
    window = torch.randn((1, 3, crop[1], crop[0]), generator=gen, device="cuda")
    model.dtype = torch.float32
    t0 = time.perf_counter()
    with torch.inference_mode():
        card_out = [o.cpu() for o in model(window)]
        cpu_model = copy.deepcopy(model).cpu()
        cpu_out = cpu_model(window.cpu())
    cpu_s = time.perf_counter() - t0
    del cpu_model
    errs = [((a - b).abs().max().item(), b.abs().max().item()) for a, b in zip(card_out, cpu_out)]
    print(f"{tag}: built in {build_s:.1f} s; f32 {crop[0]}^2 window, card vs CPU, "
          f"{len(errs)} outputs: max abs diff / max|logit| "
          f"{[f'{e:.3e}/{m:.3e}' for e, m in errs]} (tol {ZOO_F32_RTOL} x max; "
          f"{cpu_s:.1f} s with the CPU copy)")
    check(all(torch.isfinite(o).all() for o in card_out), f"{yaml}: non-finite f32 logits")
    check(all(e <= ZOO_F32_RTOL * m for e, m in errs), f"{yaml}: card vs CPU {errs}")
    model.dtype = torch.bfloat16

    # bf16 evaluate: one 1024^2 image at stride 171
    eval_cfg = cfg.clone()
    eval_cfg.VAL.IMAGE_BASE_SIZE = IMAGE_SIZE
    eval_cfg.VAL.CROP_SIZE = list(crop)
    eval_cfg.VAL.STRIDE_SIZE = [171, 171]
    eval_cfg.DATA.BATCH_SIZE_VAL = 1
    dataset = SyntheticDataset(build_val_transforms(eval_cfg), num_samples=1,
                               crop_size=(IMAGE_SIZE, IMAGE_SIZE),
                               num_classes=cfg.DATA.NUM_CLASSES, mode="val", seed=0)
    n_windows, finite = [], []

    def forward(images):
        logits = model(images)[0]
        finite.append(torch.isfinite(logits).all())
        n_windows.append(images.shape[0])
        return logits

    window_batch = 32 if crop[0] <= 256 else 16
    with torch.inference_mode():
        model(torch.randn((window_batch, 3, crop[1], crop[0]), device="cuda"))   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = evaluate(forward, dataset, eval_cfg, "cuda", window_batch=window_batch,
                          progbar=False)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        eval_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    windows_s = sum(n_windows) / eval_s
    print(f"{tag}: bf16 evaluate of one {IMAGE_SIZE}^2 image at stride 171: "
          f"{sum(n_windows)} windows of {crop[0]}^2 in {len(n_windows)} forwards, "
          f"{windows_s:.1f} windows/s end to end incl. host data, mIoU {result['miou']:.4f}, "
          f"peak memory {eval_gib:.2f} GiB ({card})")
    check(sum(n_windows) == ZOO_WINDOWS[crop[0]] and all(bool(f) for f in finite),
          f"{yaml}: {sum(n_windows)} windows, finite {[bool(f) for f in finite]}")
    check(0.0 <= result["miou"] <= 1.0, f"{yaml}: mIoU {result['miou']}")

    # bf16 train steps at the yaml's batch with its optimizer
    bs = cfg.DATA.BATCH_SIZE
    optimizer = get_optimizer(cfg, model, get_scheduler(cfg))
    step = make_train_step(model, get_loss_function(cfg), optimizer)
    batch = {"image": torch.randn((bs, 3, crop[1], crop[0]), generator=gen, device="cuda"),
             "label": torch.randint(0, cfg.DATA.NUM_CLASSES, (bs, crop[1], crop[0]),
                                    generator=gen, device="cuda")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(ZOO_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(batch))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    losses = torch.stack(losses).tolist()
    train_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = statistics.median(times[ZOO_WARMUP:])
    groups = [(len(g["params"]), g["lr_mult"]) for g in optimizer.optimizer.param_groups]
    print(f"{tag}: {ZOO_STEPS} bf16 train steps at bs {bs} {crop[0]}^2 with "
          f"{type(optimizer).__name__} (groups (params, lr x) {groups}): losses "
          f"{[round(x, 4) for x in losses]}, step times {[round(t, 2) for t in times]} ms, "
          f"{step_ms:.2f} ms per step (median of the last {ZOO_STEPS - ZOO_WARMUP}, CUDA "
          f"events), "
          f"peak memory {train_gib:.2f} GiB ({card})")
    check(all(np.isfinite(losses)), f"{yaml}: train losses {losses}")
    check(type(optimizer).__name__ == cfg.TRAIN.OPTIMIZER.NAME,
          f"{yaml}: {type(optimizer).__name__} for {cfg.TRAIN.OPTIMIZER.NAME}")
    busy = profile_step(lambda: step(batch), f"{tag}: profile of one bs-{bs} train step",
                        top=5)
    del model, step, optimizer, batch
    torch.cuda.empty_cache()
    return {"windows_s": windows_s, "step_ms": step_ms, "bs": bs, "crop": crop[0],
            "eval_gib": eval_gib, "train_gib": train_gib, "busy": busy,
            "f32_err": max(e / m for e, m in errs), "params_m": n_params / 1e6}


def phase6_optimizer(yaml, name):
    """Two steps of a yaml that trains with AdamW or Adam."""
    import numpy as np
    import torch
    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.models import get_model
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import make_train_step
    cfg = _zoo_config(yaml)
    crop, bs = tuple(cfg.DATA.CROP_SIZE), cfg.DATA.BATCH_SIZE
    torch.manual_seed(0)
    with torch.device("cuda"):
        model = get_model(cfg)
    optimizer = get_optimizer(cfg, model, get_scheduler(cfg))
    check(type(optimizer).__name__ == name, f"{yaml}: {type(optimizer).__name__}")
    step = make_train_step(model, get_loss_function(cfg), optimizer)
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = {"image": torch.randn((bs, 3, crop[1], crop[0]), generator=gen, device="cuda"),
             "label": torch.randint(0, cfg.DATA.NUM_CLASSES, (bs, crop[1], crop[0]),
                                    generator=gen, device="cuda")}
    losses = torch.stack([step(batch) for _ in range(2)]).tolist()
    moments = sum(len(s) for s in optimizer.optimizer.state.values())
    print(f"phase 6: {Path(yaml).stem}: 2 bf16 {name} steps at bs {bs} {crop[0]}^2 "
          f"(betas {cfg.TRAIN.OPTIMIZER.BETAS}, weight decay "
          f"{cfg.TRAIN.OPTIMIZER.WEIGHT_DECAY}): losses {[round(x, 4) for x in losses]}, "
          f"{moments} state tensors")
    check(all(np.isfinite(losses)) and optimizer.step_count == 2, f"{yaml}: {losses}")
    del model, step, optimizer
    torch.cuda.empty_cache()


def phase6_trainer(save_dir):
    """``train.main`` on the SETR-PUP Potsdam yaml for a few iterations with
    one save and one evaluation, then ``val.main`` on its best_model.pt:
    the training run's mIoU within F6_MIOU_TOL."""
    import json

    import numpy as np
    from emrt_tpu_torch.train import main as train_main
    from emrt_tpu_torch.val import main as val_main
    path = str(ROOT / "configs" / ZOO_YAMLS[0])
    # the flags first: the KEY VALUE overrides are one trailing positional
    flags = ["--config", path, "--device", "cuda"]
    opts = ["DATA.DATASET", "Synthetic", "TRAIN.DTYPE", "bfloat16"]
    t0 = time.perf_counter()
    run = train_main([*flags, "--seed", "0", "--iters", str(ZOO_TRAINER_ITERS), *opts,
                      "SAVE_DIR", save_dir, "LOGGING_INFO_FREQ", "2",
                      "SAVE_FREQ_CHECKPOINT", str(ZOO_TRAINER_ITERS),
                      "VALIDATE_FREQ", str(ZOO_TRAINER_ITERS)])
    train_s = time.perf_counter() - t0
    best = json.loads((Path(save_dir) / "best_model.json").read_text())["best_miou"]
    result = val_main([*flags, "--model_path", str(Path(save_dir) / "best_model.pt"), *opts])
    print(f"phase 6: train.main {ZOO_TRAINER_ITERS} iters on {Path(path).name} at bs "
          f"{_zoo_config(ZOO_YAMLS[0]).DATA.BATCH_SIZE} in {train_s:.1f} s: window losses {[round(x, 4) for x in run['losses']]}, "
          f"mIoU {run['mious']}; val.main on best_model.pt: mIoU {result['miou']:.6f} "
          f"against {best:.6f}, {result['forwards']} forwards")
    check(run["steps"] == ZOO_TRAINER_ITERS and all(np.isfinite(run["losses"])),
          f"train.main: {run['steps']} steps, losses {run['losses']}")
    check(abs(result["miou"] - best) <= F6_MIOU_TOL,
          f"best_model.pt evaluates to mIoU {result['miou']}, the training run's {best}")


# the solver phase: SegFormer-B0 with each optimizer, loss and schedule that
# no yaml trains with, the overrides of each run (a one-step warm-up, so that
# the second step is past it; the milestone at step 1)
SOLVER_YAML = "segformer/segformer_b0_512x512_160k_ade20k.yaml"
SOLVER_RUNS = (("Adadelta", {"TRAIN.OPTIMIZER.NAME": "Adadelta", "TRAIN.BASE_LR": 1.0}),
               ("RMSProp", {"TRAIN.OPTIMIZER.NAME": "RMSProp", "TRAIN.BASE_LR": 1e-4,
                            "TRAIN.OPTIMIZER.WEIGHT_DECAY": 1e-4}),
               ("MultiCrossEntropyLoss", {"TRAIN.LOSS": "MultiCrossEntropyLoss"}),
               ("OhemCrossEntropyLoss", {"TRAIN.LOSS": "OhemCrossEntropyLoss"}),
               ("WarmupPolyLR", {"TRAIN.LR_SCHEDULER.NAME": "WarmupPolyLR"}),
               ("WarmupCosineLR", {"TRAIN.LR_SCHEDULER.NAME": "WarmupCosineLR"}),
               ("WarmupMultiStepLR", {"TRAIN.LR_SCHEDULER.NAME": "WarmupMultiStepLR",
                                      "TRAIN.LR_SCHEDULER.MILESTONES": "(1,)"}))
SOLVER_COMMON = {"TRAIN.ITERS": 10, "TRAIN.LR_SCHEDULER.WARM_UP_STEPS": 1,
                 "TRAIN.LR_SCHEDULER.WARM_UP_LR_INIT": 1e-6, "TRAIN.END_LR": 1e-7}


def phase6_solver():
    """SegFormer-B0 two bf16 steps at the yaml's batch for each of
    ``SOLVER_RUNS``: the optimizer, loss and schedule the config names,
    finite losses, and the learning rate each step ran with equal to the
    schedule's (a check of the wiring: the schedules' values are held to
    the JAX package's by tests/test_torch_solver.py)."""
    import numpy as np
    import torch
    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.models import get_model
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import make_train_step
    base = _zoo_config(SOLVER_YAML, SOLVER_COMMON.items())
    crop, bs = tuple(base.DATA.CROP_SIZE), base.DATA.BATCH_SIZE
    torch.manual_seed(0)
    with torch.device("cuda"):
        model = get_model(base)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(8)
    batch = {"image": torch.randn((bs, 3, crop[1], crop[0]), generator=gen, device="cuda"),
             "label": torch.randint(0, base.DATA.NUM_CLASSES, (bs, crop[1], crop[0]),
                                    generator=gen, device="cuda")}
    for name, overrides in SOLVER_RUNS:
        cfg = _zoo_config(SOLVER_YAML, [*SOLVER_COMMON.items(), *overrides.items()])
        model.load_state_dict(init)
        optimizer = get_optimizer(cfg, model, get_scheduler(cfg))
        loss_fn = get_loss_function(cfg)
        step = make_train_step(model, loss_fn, optimizer)
        losses, lrs = [], []
        for _ in range(2):
            losses.append(step(batch))
            lrs.append(optimizer.optimizer.param_groups[0]["lr"])
        losses = torch.stack(losses).tolist()
        cpu_schedule = get_scheduler(cfg.clone())
        want = [cpu_schedule(i) for i in range(2)]
        line = (f"phase 6: solver {name:22s} on {Path(SOLVER_YAML).stem} bs {bs} {crop[0]}^2: "
                f"{type(optimizer).__name__} / {type(loss_fn).__name__} / "
                f"{cfg.TRAIN.LR_SCHEDULER.NAME}: losses {[round(x, 4) for x in losses]}, "
                f"lr {lrs} (schedule {want})")
        print(line)
        check(all(np.isfinite(losses)) and losses[0] > 0, f"solver {name}: losses {losses}")
        check(lrs == want and lrs[0] != lrs[1], f"solver {name}: lr {lrs}, schedule {want}")
        check(type(loss_fn).__name__ == cfg.TRAIN.LOSS, f"solver {name}: {type(loss_fn)}")
        check(name not in ("Adadelta", "RMSProp") or type(optimizer).__name__ == name,
              f"solver {name}: {type(optimizer).__name__}")
        del step, optimizer
    del model
    torch.cuda.empty_cache()


def phase6(card):
    """The zoo at full width on the card; none of its paths runs K1-K3."""
    import tempfile
    _reset_counts()
    rows = {Path(y).stem: phase6_model(y, card) for y in ZOO_YAMLS}
    for yaml, name in ZOO_OPTIMIZER_YAMLS:
        phase6_optimizer(yaml, name)
    phase6_solver()
    with tempfile.TemporaryDirectory() as save_dir:
        phase6_trainer(save_dir)
    launches = _counts()
    check(launches == (0, 0), f"the zoo launched the deformable kernels {launches}")
    print(f"phase 6: per zoo yaml (full width, seeded random weights, bf16; {card}):")
    for name, r in rows.items():
        busy = "n/a" if r["busy"] is None else f"{100 * r['busy']:.1f}%"
        print(f"  {name[:48]:48s} {r['params_m']:6.1f}M evaluate {r['windows_s']:7.1f} "
              f"windows/s of {r['crop']}^2 (peak {r['eval_gib']:.2f} GiB), train step bs "
              f"{r['bs']} {r['step_ms']:8.2f} ms (peak {r['train_gib']:.2f} GiB, device busy "
              f"{busy}), f32 card vs CPU {r['f32_err']:.2e} x max")
    print(f"phase 6: K1 / K2-K3 launches across phase 6: {launches}")
    return rows


# ---------------------------------------------------------------- phase 7: DP

DP_WORLD, DP_BS = 2, 4                   # (a): two ranks of 4 against one process of 8
DP_ITERS, DP_RESUME_ITERS, DP_TIMED = 4, 6, 5
# (a): the DP loss against the one process's: the two differ in float32 sum
# order only (equal to 7 digits on the H100)
DP_LOSS_RTOL = 1e-5
# BatchNorm running statistics of the DP step against the one-process step,
# as a share of each tensor's largest value
DP_STATS_TOL = 1e-4
# (e): train.main's iterations under torchrun
DP_TORCHRUN_ITERS = 2


def _dp_step(model, cfg, device):
    """make_train_step over ``model`` with SyncBatchNorm under DDP, as the
    train CLI builds it."""
    from torch.nn.parallel import DistributedDataParallel
    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.parallel import convert_sync_batchnorm
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import make_train_step
    convert_sync_batchnorm(model)
    optimizer = get_optimizer(cfg, model, get_scheduler(cfg))
    ddp = DistributedDataParallel(model, device_ids=[device], broadcast_buffers=False)
    return make_train_step(ddp, get_loss_function(cfg), optimizer)


def dp_reference(path, dropout=0.0, cfg=None, seed=0, control=False, dtype="float32"):
    """(a)'s global batch of 8 and one process's float32 (or ``dtype``) step
    on it, which ``grid_step_rank`` then runs in (dropout
    ``dropout``, torch seeded with SP_SEED + ``seed`` before it; BatchNorm on
    batch statistics, through the kernels) of the flagship (or of ``cfg``'s
    model), its weights from torch's seed ``seed``, saved at ``path`` with
    the initial weights, its gradients (clipped), running statistics and
    gradient norm before the clip; phases 8, 9 and 10 take it too (9 and 10
    with dropout, 10 also for the HRNet and ResNeSt EMRTs). With ``control``
    also the gradient norm of the same step on images moved by CONTROL_EPS
    relative: how far float32 rounding alone moves the norm. Rank 1's rows
    differ from rank 0's in what a data-parallel fault would weigh wrongly:
    their images have another mean and scale (BatchNorm statistics taken per
    rank), their labels other classes, and 80-100% of their pixels are
    ignored (a mean of the ranks' means)."""
    import torch
    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import make_train_step
    cfg = _train_config() if cfg is None else cfg
    cfg.TRAIN.DTYPE = "float32"
    torch.manual_seed(seed)
    model = _built_on(cfg, "cuda", torch.float32)
    init = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    model.to(getattr(torch, dtype))
    _set_kernel_and_dropout(model, dropout=dropout)
    gen = torch.Generator(device="cuda").manual_seed(7 + seed)
    n, (h, w) = DP_WORLD * DP_BS, cfg.DATA.CROP_SIZE
    half = cfg.DATA.NUM_CLASSES // 2
    labels = torch.randint(0, half, (n, h, w), generator=gen, device="cuda")
    labels[DP_BS:] += half
    share = torch.tensor([0.0, 0.1, 0.0, 0.2, 0.9, 1.0, 0.8, 0.9], device="cuda")
    ignored = torch.rand((n, h, w), generator=gen, device="cuda") < share[:, None, None]
    images = torch.randn((n, 3, h, w), generator=gen, device="cuda")
    images[DP_BS:] = 3 * images[DP_BS:] + 2
    images = images.to(getattr(torch, dtype))
    batch = {"image": images, "label": torch.where(ignored, 255, labels)}
    optimizer = get_optimizer(cfg, model, get_scheduler(cfg))
    step = make_train_step(model, get_loss_function(cfg), optimizer)
    torch.manual_seed(SP_SEED + seed)
    loss = step(batch).item()
    norm = optimizer.grad_norm.item()
    # zeros for a parameter no path reads (CSwin's and ViT's tap-0 LayerNorm)
    grads = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).flatten()
                       for p in model.parameters()]).cpu()
    stats = {k: v.cpu() for k, v in model.state_dict().items() if "running" in k}
    learned = {n: p.grad.cpu() for n, p in model.named_parameters() if n in LEARNED_REFERENCE}
    norm_control = None
    if control:
        model.load_state_dict(init)
        optimizer = get_optimizer(cfg, model, get_scheduler(cfg))
        step = make_train_step(model, get_loss_function(cfg), optimizer)
        torch.manual_seed(SP_SEED + seed)
        step({"image": images * (1 + CONTROL_EPS), "label": batch["label"]})
        norm_control = optimizer.grad_norm.item()
    torch.save({"init": init, "loss": loss, "batch": {k: v.cpu() for k, v in batch.items()},
                "dtype": dtype, "norm": norm, "norm_control": norm_control,
                "dropout_seed": SP_SEED + seed,
                "grads": grads, "learned_reference": learned, "stats": stats}, path)
    del model, step
    torch.cuda.empty_cache()
    return str(path)


def dp_step_rank(rank, world, devices, reference):
    """(a) and (b) on one rank: one float32 DP step of rows [4r, 4r + 4) of
    the global batch at ``reference`` (``dp_reference``), its loss as the
    train CLI logs it (the ranks' mean), gradients and running statistics
    against the one-process step's, and its kernel launches."""
    import torch
    from emrt_tpu_torch.models import get_model
    from emrt_tpu_torch.parallel.mesh import all_reduce_sum
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(devices[rank])
    torch.cuda.set_device(device)
    ref = torch.load(reference, weights_only=True)
    cfg = _train_config()
    cfg.TRAIN.DTYPE = "float32"
    model = get_model(cfg, device=device, dtype=torch.float32)
    model.load_state_dict(ref["init"])
    _set_kernel_and_dropout(model, dropout=0.0)
    step = _dp_step(model, cfg, device)
    part = slice(rank * DP_BS, (rank + 1) * DP_BS)
    batch = {k: v[part].to(device) for k, v in ref["batch"].items()}
    _reset_counts()
    loss = step(batch)
    torch.cuda.synchronize()
    out = {"launches_a": _counts()}
    out["loss"], out["loss_ref"] = (all_reduce_sum(loss.clone()) / world).item(), ref["loss"]
    grads = torch.cat([p.grad.flatten() for p in model.parameters()]).cpu()
    out["grad_rel"] = ((grads - ref["grads"]).norm() / ref["grads"].norm()).item()
    stats = {k: v.cpu() for k, v in model.state_dict().items() if "running" in k}
    out["stats_rel"] = max(((stats[k] - v).abs().max() / v.abs().max()).item()
                           for k, v in ref["stats"].items())
    out["n_stats"] = len(stats)
    del model, step, grads
    torch.cuda.empty_cache()
    return out


def dp_step_failures(out) -> list[str]:
    """The checks of (a) and (b) that ``dp_step_rank``'s result fails."""
    checks = (
        (abs(out["loss"] - out["loss_ref"]) <= DP_LOSS_RTOL * abs(out["loss_ref"]),
         f"DP loss {out['loss']} vs one process's {out['loss_ref']} (rtol {DP_LOSS_RTOL})"),
        (out["grad_rel"] <= TRAIN_BN_GRAD_RTOL,
         f"DP gradients differ by {out['grad_rel']} (L2, tol {TRAIN_BN_GRAD_RTOL})"),
        (out["n_stats"] > 100 and out["stats_rel"] <= DP_STATS_TOL,
         f"running statistics differ by {out['stats_rel']} x max (tol {DP_STATS_TOL})"),
        (tuple(out["launches_a"]) == (6, 6),
         f"a DP step launched forward/backward {out['launches_a']}"))
    return [what for ok, what in checks if not ok]


def phase7_rank(rank, world, devices, reference, save_dir):
    """One rank of phase 7, a process of its own (``parallel.launch``):
    (a), (b) (``dp_step_rank``); (c) ``train.main`` (bf16, 8 rows a rank,
    ``--device cuda``: the rank's card) with a save and an eval, then
    ``--resume``; (d) the bf16 DP step's ms and peak memory. Returns numbers
    only."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from emrt_tpu_torch.models import get_model
    from emrt_tpu_torch.train import main as train_main
    from emrt_tpu_torch.utils import checkpoint
    out = dp_step_rank(rank, world, devices, reference)
    device = torch.device(devices[rank])

    written = []
    save = checkpoint._save

    def counting_save(obj, path):
        written.append(Path(path).name)
        save(obj, path)

    checkpoint._save = counting_save
    common = ["--config", str(CONFIG), "--device", "cuda", "--seed", "0",
              "DATA.DATASET", "Synthetic", "DATA.BATCH_SIZE", str(TRAIN_BS),
              "TRAIN.DTYPE", "bfloat16", "SAVE_DIR", save_dir,
              "LOGGING_INFO_FREQ", "2", "SAVE_FREQ_CHECKPOINT", str(DP_ITERS),
              "VALIDATE_FREQ", str(DP_ITERS)]
    _reset_counts()
    t0 = time.perf_counter()
    first = train_main(["--iters", str(DP_ITERS), *common])
    second = train_main(["--iters", str(DP_RESUME_ITERS), "--resume", *common])
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["launches_c"] = _counts()
    out["first"], out["second"], out["written"] = first, second, written
    checkpoint._save = save

    cfg = _train_config()
    torch.manual_seed(0)
    model = get_model(cfg, device=device)
    step = _dp_step(model, cfg, device)
    gen = torch.Generator(device=device).manual_seed(3 + rank)
    h, w = cfg.DATA.CROP_SIZE
    batch = {"image": torch.randn((TRAIN_BS, 3, h, w), generator=gen, device=device),
             "label": torch.randint(0, cfg.DATA.NUM_CLASSES, (TRAIN_BS, h, w),
                                    generator=gen, device=device)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    out["step_ms"] = cuda_ms(lambda: step(batch), reps=DP_TIMED, warmup=2)
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    grads = torch.ones(sum(p.numel() for p in model.parameters()), device=device)
    out["allreduce_ms"] = cuda_ms(lambda: dist.all_reduce(grads), reps=DP_TIMED, warmup=1)
    out["finite"] = bool(np.isfinite(first["losses"] + second["losses"]).all())
    return out


def phase7_leg(card, backend, devices, reference, save_dir):
    """Phase 7 over ``backend`` with rank r on ``devices[r]``: the checks of
    (a)-(d) and single-process ``val.main`` on the DP run's best_model.pt.
    Returns the kernels' launches in the two ranks' ``train.main`` runs."""
    import json

    from emrt_tpu_torch.parallel.launch import run_ranks
    from emrt_tpu_torch.val import main as val_main
    t0 = time.perf_counter()
    ranks = run_ranks(phase7_rank, DP_WORLD, args=(devices, reference, save_dir),
                      backend=backend, timeout=900)
    save_dir = Path(save_dir)
    leg = f"phase 7 ({backend}, {DP_WORLD} ranks on {', '.join(devices)})"
    print(f"{leg}: the ranks ran in {time.perf_counter() - t0:.1f} s")
    for r, out in enumerate(ranks):
        print(f"{leg}: rank {r} (a) float32 DP step of {DP_BS} rows: loss {out['loss']:.9g} "
              f"against one process's {out['loss_ref']:.9g} on all {DP_WORLD * DP_BS} (rtol "
              f"{DP_LOSS_RTOL}); gradients |dp-one|/|one| (L2) {out['grad_rel']:.3e} (tol "
              f"{TRAIN_BN_GRAD_RTOL}); BatchNorm running statistics within "
              f"{out['stats_rel']:.3e} x max ({out['n_stats']} tensors, tol {DP_STATS_TOL}); "
              f"(b) launches forward/backward {out['launches_a']}")
        failures = dp_step_failures(out)
        check(not failures, f"rank {r}: {'; '.join(failures)}")
        first, second = out["first"], out["second"]
        steps = first["steps"] + second["steps"]
        forwards = first["eval_forwards"] + second["eval_forwards"] + (
            2 * FLOPS_FORWARDS if r == 0 else 0)
        print(f"{leg}: rank {r} (c) train.main bf16 {TRAIN_BS} rows a rank, {DP_ITERS} + "
              f"{DP_RESUME_ITERS - DP_ITERS} iterations (--resume) in {out['train_s']:.1f} s: "
              f"window losses {[round(x, 4) for x in first['losses'] + second['losses']]}, "
              f"mIoU {first['mious'] + second['mious']}, {forwards} eval and FLOPs forwards, "
              f"launches forward/backward {out['launches_c']}, files written {out['written']}")
        check(out["finite"], f"rank {r}: losses {first['losses'] + second['losses']}")
        check(first["last_iter"] == DP_ITERS and second["start_iter"] == DP_ITERS
              and second["last_iter"] == DP_RESUME_ITERS,
              f"rank {r}: ran to {first['last_iter']}, resumed {second['start_iter']} -> "
              f"{second['last_iter']}")
        check(tuple(out["launches_c"]) == (6 * (steps + forwards), 6 * steps),
              f"rank {r}: launches {out['launches_c']} for {steps} steps and {forwards} "
              f"forwards")
        check(bool(out["written"]) == (r == 0), f"rank {r} wrote {out['written']}")
        check(first["losses"] == ranks[0]["first"]["losses"]
              and second["mious"] == ranks[0]["second"]["mious"],
              f"rank {r} logged other losses or mIoU than rank 0")
        note = ("two ranks share one card: not a scaling figure" if len(set(devices)) == 1
                else "one card a rank")
        print(f"{leg}: rank {r} (d) bf16 DP step, {TRAIN_BS} rows a rank: "
              f"{out['step_ms']:.2f} ms (median of {DP_TIMED}, CUDA events), peak memory "
              f"{out['peak_gib']:.2f} GiB; one all-reduce of the model's float32 gradients "
              f"alone {out['allreduce_ms']:.2f} ms ({card}; {note})")
    check(sorted(p.name for p in (save_dir / "checkpoints").iterdir())
          == [f"iter_{DP_RESUME_ITERS}.pt"], "checkpoints after --resume")
    best = json.loads((save_dir / "best_model.json").read_text())["best_miou"]
    check(best == max(ranks[0]["first"]["mious"] + ranks[0]["second"]["mious"]),
          f"best_model.json {best}")
    _reset_counts()
    result = val_main(["--config", str(CONFIG), "--device", "cuda", "--model_path",
                       str(save_dir / "best_model.pt"), "DATA.DATASET", "Synthetic",
                       "TRAIN.DTYPE", "bfloat16"])
    print(f"{leg}: one-process val.main on the DP run's best_model.pt: mIoU "
          f"{result['miou']:.6f} against the DP run's {best:.6f}")
    check(abs(result["miou"] - best) <= F6_MIOU_TOL,
          f"val.main gives mIoU {result['miou']}, the DP run {best}")
    return tuple(sum(out["launches_c"][i] for out in ranks) for i in range(2))


def _run_group(cmd, timeout: float) -> str:
    """Run ``cmd`` from the checkout's root in a session of its own and
    return its standard output; the whole session is killed if it does not
    end within ``timeout`` seconds, and a non-zero exit raises."""
    import os
    import signal
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RuntimeError(f"{' '.join(cmd)} did not end in {timeout:.0f} s:\n{out[-4000:]}")
    check(proc.returncode == 0, f"{' '.join(cmd)} exited {proc.returncode}:\n{out[-4000:]}")
    return out


def phase7_torchrun(save_dir):
    """(e) The CLIs as a user launches them: ``torchrun --nproc_per_node 2 -m
    emrt_tpu_torch.train --device cuda`` (each rank joins the group from
    torchrun's environment, on ``cuda:LOCAL_RANK`` modulo the cards, over
    NCCL where each rank has a card and gloo where they share one), then
    ``-m emrt_tpu_torch.val`` on its best_model.pt: the sharded val's mIoU
    equals the training run's best."""
    import json

    import torch
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", str(DP_WORLD), "-m"]
    common = ["--config", str(CONFIG), "--device", "cuda"]
    opts = ["DATA.DATASET", "Synthetic", "DATA.BATCH_SIZE", str(TRAIN_BS), "TRAIN.DTYPE",
            "bfloat16", "SAVE_DIR", save_dir]
    backend = "nccl" if torch.cuda.device_count() >= DP_WORLD else "gloo"
    t0 = time.perf_counter()
    out = _run_group([*launch, "emrt_tpu_torch.train", *common, "--iters",
                      str(DP_TORCHRUN_ITERS), *opts], timeout=600)
    check(f"ranks: {DP_WORLD}" in out and f"training done at iter {DP_TORCHRUN_ITERS}" in out,
          f"torchrun train.main:\n{out[-4000:]}")
    best = json.loads((Path(save_dir) / "best_model.json").read_text())["best_miou"]
    out = _run_group([*launch, "emrt_tpu_torch.val", *common, "--model_path",
                      str(Path(save_dir) / "best_model.pt"), *opts], timeout=600)
    found = re.findall(r"final mIoU: ([0-9.]+)", out)
    check(f"ranks: {DP_WORLD}" in out and len(found) == 1, f"torchrun val.main:\n{out[-4000:]}")
    print(f"phase 7 (e): torchrun --nproc_per_node {DP_WORLD} (over {backend}) "
          f"train.main --device cuda, {DP_TORCHRUN_ITERS} iterations, then val.main on its "
          f"best_model.pt, in {time.perf_counter() - t0:.1f} s: val mIoU {found[0]} against "
          f"the run's {best:.6f}")
    check(abs(float(found[0]) - best) <= F6_MIOU_TOL,
          f"torchrun val.main gives mIoU {found[0]}, the run {best}")


def phase7(card):
    """Data parallelism (``emrt_tpu_torch.parallel``): two ranks on the one
    card over gloo (NCCL refuses two ranks on one device), then over NCCL
    with a card a rank where there are two; then the CLIs under torchrun.
    Returns the forward and backward launches of the ranks' ``train.main``
    runs."""
    import tempfile

    import torch
    torch.cuda.empty_cache()
    launches = (0, 0)
    with tempfile.TemporaryDirectory() as tmp:
        reference = dp_reference(Path(tmp) / "reference.pt")
        legs = [("gloo", ["cuda:0"] * DP_WORLD)]
        if torch.cuda.device_count() >= DP_WORLD:
            legs.append(("nccl", [f"cuda:{r}" for r in range(DP_WORLD)]))
        for backend, devices in legs:
            got = phase7_leg(card, backend, devices, reference, str(Path(tmp) / backend))
            launches = tuple(a + b for a, b in zip(launches, got))
        phase7_torchrun(str(Path(tmp) / "torchrun"))
    if torch.cuda.device_count() < DP_WORLD:
        print(f"phase 7: the NCCL leg was not run: {torch.cuda.device_count()} card(s), "
              f"it needs {DP_WORLD}")
    print(f"phase 7: K1 / K2-K3 launches in the ranks' train.main runs: {launches}")
    return launches


# ---------------------------------------------------------------- phase 8: TP

TP_WORLD = 2                             # (a), (b), (d): dp1 x tp2 on 8 rows
TP_GRID = (2, 2)                         # (c): dp2 x tp2 (data x model), four ranks
TP_ITERS, TP_RESUME_ITERS, TP_TIMED = 2, 3, 5
TP_DROPOUT = 0.1
# the flagship's split parameters: 4 in each of its 6 deformable layers, 3 in
# each of its decoder's 2 MHAs
TP_SPLIT = 4 * 6 + 2 * 3
# (a): the norm of the whole gradient before the clip, against one process's
# (read 1.7e-6 to 5.3e-5 apart on the H100), and the gathered gradient's
# norm after the clip, against GRAD_CLIP (taken in float64; the float32
# rounding of the clip's own norm, 7.4e-8 to 8.6e-8 read). A norm over the
# rank's own shards (the group sum taken out) read 1.9e-4 off before the
# clip and 2.0e-4 after it: the second bound holds it by three orders
TP_NORM_RTOL, TP_CLIPPED_RTOL = 1e-4, 1e-6
# (a): the learned reference points' gradients (the decoder's
# ``reference_points`` Linear and the query embedding it reads), relative L2
# against one process's: their gradient comes back through every head's
# sampling locations, so a rank that kept only its own heads' share misses
# part of it (read 2.9e-4 to 4.1e-4 sound, 0.18 to 0.64 with the reference
# points' ``copy_in`` taken out; H100). And the largest spread over the model
# group of a replicated gradient before the optimizer gives it model rank
# 0's (``GradientSync.spread``, relative to the tensor's largest entry). The
# ranks' backward kernels add with atomics in no fixed order and BatchNorm's
# backward amplifies that: up to 3.1e-5 read sound, 0.78 to 1.03 on the
# reference points with the fault. Held over the tensors whose largest
# entry is at least TP_SPREAD_FLOOR of the model's largest: below it lie the
# biases of the convs that a BatchNorm follows (~1e-9 of it), zero in exact
# arithmetic, whose spread is all rounding
LEARNED_REFERENCE = ("model.reference_points.weight", "model.reference_points.bias",
                     "model.query_pos_embed.weight")
TP_REFERENCE_RTOL, TP_SPREAD_TOL, TP_SPREAD_FLOOR = 1e-2, 1e-3, 1e-6
# (e): train.main's iterations under torchrun
TP_TORCHRUN_ITERS = 2


def _record_heads(seen: set, queries: bool = False):
    """Wrap the kernels' wrappers to add ("fwd" / "bwd", heads) to ``seen``
    at each call, ("fwd" / "bwd", heads, queries) with ``queries`` (the
    launch counts stay the wrappers' own)."""
    from emrt_tpu_torch.ops import deformable_cuda
    fwd, bwd = deformable_cuda.ms_deform_attn_fwd, deformable_cuda.ms_deform_attn_bwd

    def call(kind, value, loc):
        return (kind, value.shape[2], loc.shape[1]) if queries else (kind, value.shape[2])

    def fwd_heads(value, shapes, loc, *a, **k):
        seen.add(call("fwd", value, loc))
        return fwd(value, shapes, loc, *a, **k)

    def bwd_heads(value, shapes, loc, *a, **k):
        seen.add(call("bwd", value, loc))
        return bwd(value, shapes, loc, *a, **k)

    deformable_cuda.ms_deform_attn_fwd, deformable_cuda.ms_deform_attn_bwd = fwd_heads, bwd_heads


def _tp_step(cfg, device, init=None, dropout=None):
    """The flagship split over this rank's model group as the train CLI
    splits it (``split_model_``, SyncBatchNorm, DDP over the data group
    where it has more than one rank) and its train step. Returns (model,
    optimizer, step, names of the split parameters)."""
    import torch
    from torch.nn.parallel import DistributedDataParallel
    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.models import get_model
    from emrt_tpu_torch.parallel import convert_sync_batchnorm
    from emrt_tpu_torch.parallel.mesh import data_group, data_world, model_group, model_rank
    from emrt_tpu_torch.parallel.tensor import split_model_, splits_of
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import make_train_step
    dtype = torch.float32 if cfg.TRAIN.DTYPE == "float32" else torch.bfloat16
    model = get_model(cfg, device=device, dtype=dtype)
    if init is not None:
        model.load_state_dict(init)
    _set_kernel_and_dropout(model, dropout=dropout)
    split = set(splits_of(model))
    split_model_(model, model_rank(), cfg.PARALLEL.MODEL, model_group())
    convert_sync_batchnorm(model)
    optimizer = get_optimizer(cfg, model, get_scheduler(cfg))
    trained = model if data_world() == 1 else DistributedDataParallel(
        model, device_ids=[device], broadcast_buffers=False, process_group=data_group())
    return model, optimizer, make_train_step(trained, get_loss_function(cfg), optimizer), split


def tp_step_rank(rank, world, devices, reference):
    """(a), (b) and (d) on one rank of dp1 x tp2: one float32 step of the 8
    rows at ``reference`` (``dp_reference``) with the model split over the
    two ranks, its loss, gathered gradients, running statistics and gradient
    norm against the one-process step's, and the heads and launches of its
    kernels; then a step with dropout 0.1 after which the replicated
    parameters must be bitwise equal on both ranks (their SHA-256); then
    the bf16 step's time and peak memory."""
    import hashlib

    import torch
    from emrt_tpu_torch.parallel.mesh import model_parallel
    from emrt_tpu_torch.parallel.tensor import join_tensor, shard_of, splits_of
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(devices[rank])
    torch.cuda.set_device(device)
    ref = torch.load(reference, weights_only=True)
    cfg = _train_config()
    cfg.TRAIN.DTYPE = "float32"
    cfg.PARALLEL.MODEL = TP_WORLD
    out = {}
    with model_parallel(TP_WORLD):
        model, optimizer, step, split = _tp_step(cfg, device, ref["init"], dropout=0.0)
        optimizer.sync.spread = {}
        specs = splits_of(model)
        batch = {k: v.to(device) for k, v in ref["batch"].items()}
        heads = set()
        _record_heads(heads)
        _reset_counts()
        loss = step(batch)
        torch.cuda.synchronize()
        out["launches_a"], out["heads"] = _counts(), sorted(heads)
        out["loss"], out["loss_ref"] = loss.item(), ref["loss"]
        out["norm"], out["norm_ref"] = optimizer.grad_norm.item(), ref["norm"]
        spread = optimizer.sync.spread
        gmax = {n: p.grad.abs().max().item() for n, p in model.named_parameters()
                if n in spread}
        top = max(gmax.values())
        held = {n: v for n, v in spread.items() if gmax[n] >= TP_SPREAD_FLOOR * top}
        out["spread"] = max(held.items(), key=lambda kv: kv[1])
        out["n_spread"], out["spread_floor"] = len(held), sorted(set(spread) - set(held))
        out["reference_rel"] = {n: ((p.grad.cpu() - ref["learned_reference"][n]).norm()
                                    / ref["learned_reference"][n].norm()).item()
                                for n, p in model.named_parameters()
                                if n in ref["learned_reference"]}
        shard, grads = shard_of(model), []
        for name, p in model.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad.contiguous()
            if name in split:
                parts = [torch.empty_like(g) for _ in range(TP_WORLD)]
                dist.all_gather(parts, g, group=shard.group)
                g = join_tensor(parts, specs[name])
            grads.append(g.flatten())
        grads = torch.cat(grads).cpu()
        out["clipped_norm"] = grads.double().norm().item()
        out["clip"] = cfg.TRAIN.OPTIMIZER.GRAD_CLIP
        out["grad_rel"] = ((grads - ref["grads"]).norm() / ref["grads"].norm()).item()
        stats = {k: v.cpu() for k, v in model.state_dict().items() if "running" in k}
        out["stats_rel"] = max(((stats[k] - v).abs().max() / v.abs().max()).item()
                               for k, v in ref["stats"].items())
        out["n_stats"], out["n_split"] = len(stats), len(split)

        _set_kernel_and_dropout(model, dropout=TP_DROPOUT)
        torch.manual_seed(1)
        step(batch)
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for name, p in model.named_parameters():
            if name not in split:
                digest.update(p.detach().cpu().numpy().tobytes())
        out["replicated_sha256"] = digest.hexdigest()
        del model, optimizer, step, grads
        torch.cuda.empty_cache()

        cfg = _train_config()
        cfg.PARALLEL.MODEL = TP_WORLD
        torch.manual_seed(0)
        _, _, step, _ = _tp_step(cfg, device)
        gen = torch.Generator(device=device).manual_seed(3)
        h, w = cfg.DATA.CROP_SIZE
        batch = {"image": torch.randn((TRAIN_BS, 3, h, w), generator=gen, device=device),
                 "label": torch.randint(0, cfg.DATA.NUM_CLASSES, (TRAIN_BS, h, w),
                                        generator=gen, device=device)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        out["step_ms"] = cuda_ms(lambda: step(batch), reps=TP_TIMED, warmup=2)
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        del step
        torch.cuda.empty_cache()
    return out


def tp_step_failures(out) -> list[str]:
    """The checks of (a) and (b) that ``tp_step_rank``'s result fails."""
    checks = (
        (abs(out["loss"] - out["loss_ref"]) <= DP_LOSS_RTOL * abs(out["loss_ref"]),
         f"TP loss {out['loss']} vs one process's {out['loss_ref']} (rtol {DP_LOSS_RTOL})"),
        (out["grad_rel"] <= TRAIN_BN_GRAD_RTOL,
         f"TP gradients differ by {out['grad_rel']} (L2, tol {TRAIN_BN_GRAD_RTOL})"),
        (out["n_stats"] > 100 and out["stats_rel"] <= DP_STATS_TOL,
         f"running statistics differ by {out['stats_rel']} x max (tol {DP_STATS_TOL})"),
        (abs(out["norm"] - out["norm_ref"]) <= TP_NORM_RTOL * out["norm_ref"],
         f"gradient norm {out['norm']} vs one process's {out['norm_ref']} "
         f"(rtol {TP_NORM_RTOL})"),
        (len(out["reference_rel"]) == len(LEARNED_REFERENCE)
         and max(out["reference_rel"].values()) <= TP_REFERENCE_RTOL,
         f"the learned reference points' gradients differ by {out['reference_rel']} (L2, "
         f"tol {TP_REFERENCE_RTOL})"),
        (out["n_spread"] > 300 and out["spread"][1] <= TP_SPREAD_TOL,
         f"the replicated gradient {out['spread'][0]} differs over the model group by "
         f"{out['spread'][1]} x its max before the optimizer gives it rank 0's "
         f"(tol {TP_SPREAD_TOL})"),
        (abs(out["clipped_norm"] - min(out["clip"], out["norm"]))
         <= TP_CLIPPED_RTOL * min(out["clip"], out["norm"]),
         f"the gathered gradient after the clip has norm {out['clipped_norm']}, not "
         f"min(GRAD_CLIP {out['clip']}, its norm {out['norm']}) (rtol {TP_CLIPPED_RTOL})"),
        (out["n_split"] == TP_SPLIT,
         f"{out['n_split']} split parameters (4 in each of 6 layers, 3 in each of 2 MHAs)"),
        (tuple(out["launches_a"]) == (6, 6),
         f"a TP step launched forward/backward {out['launches_a']}"),
        (out["heads"] == [("bwd", HEADS // TP_WORLD), ("fwd", HEADS // TP_WORLD)],
         f"the kernels ran at heads {out['heads']}, not {HEADS // TP_WORLD}"))
    return [what for ok, what in checks if not ok]


def _tp_train_argv(save_dir, *extra):
    return ["--config", str(CONFIG), "--device", "cuda", "--seed", "0",
            "DATA.DATASET", "Synthetic", "DATA.BATCH_SIZE", str(TRAIN_BS),
            "TRAIN.DTYPE", "bfloat16", "SAVE_DIR", save_dir, "LOGGING_INFO_FREQ", "1",
            "SAVE_FREQ_CHECKPOINT", str(TP_ITERS), "VALIDATE_FREQ", str(TP_ITERS),
            "PARALLEL.MODEL", str(TP_GRID[1]), *extra]


def tp_train_rank(rank, world, save_dir):
    """(c) on one rank of dp2 x tp2: ``train.main --device cuda`` (bf16, 8
    rows a data rank) with a save and a sharded eval, then ``--resume``.
    Returns the summaries, the files this rank wrote, its launches and
    the kernels' heads."""
    import numpy as np
    import torch
    from emrt_tpu_torch.train import main as train_main
    from emrt_tpu_torch.utils import checkpoint
    written = []
    save = checkpoint._save

    def counting_save(obj, path):
        written.append(Path(path).name)
        save(obj, path)

    checkpoint._save = counting_save
    heads = set()
    _record_heads(heads)
    _reset_counts()
    t0 = time.perf_counter()
    first = train_main(["--iters", str(TP_ITERS), *_tp_train_argv(save_dir)])
    second = train_main(["--iters", str(TP_RESUME_ITERS), "--resume",
                         *_tp_train_argv(save_dir)])
    torch.cuda.synchronize()
    return {"train_s": time.perf_counter() - t0, "launches": _counts(), "heads": sorted(heads),
            "first": first, "second": second, "written": written,
            "finite": bool(np.isfinite(first["losses"] + second["losses"]).all())}


def phase8_step(card, backend, devices, reference):
    """(a), (b) and (d) over ``backend``: dp1 x tp2 with rank r on
    ``devices[r]``. Returns the kernels' launches in the ranks' runs."""
    from emrt_tpu_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(tp_step_rank, TP_WORLD, args=(devices[:TP_WORLD], reference),
                      backend=backend, timeout=600)
    leg = f"phase 8 ({backend})"
    print(f"{leg}: dp1 x tp{TP_WORLD} on {', '.join(devices[:TP_WORLD])}: the ranks ran in "
          f"{time.perf_counter() - t0:.1f} s")
    for r, out in enumerate(ranks):
        print(f"{leg}: rank {r} (a) float32 dp1 x tp{TP_WORLD} step of 8 rows: loss "
              f"{out['loss']:.9g} against one process's {out['loss_ref']:.9g} (rtol "
              f"{DP_LOSS_RTOL}); gathered gradients |tp-one|/|one| (L2) {out['grad_rel']:.3e} "
              f"(tol {TRAIN_BN_GRAD_RTOL}); BatchNorm running statistics within "
              f"{out['stats_rel']:.3e} x max (tol {DP_STATS_TOL}); gradient norm before the "
              f"clip {out['norm']:.9g} against {out['norm_ref']:.9g} (rtol {TP_NORM_RTOL}), "
              f"after it {out['clipped_norm']:.9g} (GRAD_CLIP {out['clip']}, rtol "
              f"{TP_CLIPPED_RTOL}); learned reference points' gradients |tp-one|/|one| (L2) "
              f"{', '.join(f'{v:.3e}' for v in out['reference_rel'].values())} (tol "
              f"{TP_REFERENCE_RTOL}); largest spread of {out['n_spread']} replicated "
              f"gradients over the ranks before the overwrite {out['spread'][1]:.3e} x max "
              f"({out['spread'][0]}; tol {TP_SPREAD_TOL}; at rounding level, not held: "
              f"{', '.join(out['spread_floor'])}); "
              f"{out['n_split']} split parameters; (b) launches forward/backward "
              f"{out['launches_a']} at heads {out['heads']}")
        failures = tp_step_failures(out)
        check(not failures, f"rank {r}: {'; '.join(failures)}")
        note = ("the ranks share one card: not a scaling figure"
                if len(set(devices[:TP_WORLD])) == 1 else "one card a rank")
        print(f"{leg}: rank {r} (d) bf16 dp1 x tp{TP_WORLD} step, {TRAIN_BS} rows: "
              f"{out['step_ms']:.2f} ms (median of {TP_TIMED}, CUDA events), peak memory "
              f"{out['peak_gib']:.2f} GiB ({card}; {note})")
    check(len({out["replicated_sha256"] for out in ranks}) == 1,
          f"the replicated parameters differ between the ranks after a step with dropout "
          f"{TP_DROPOUT}")
    print(f"{leg}: (a) after a step with dropout {TP_DROPOUT} the replicated parameters are "
          f"bitwise equal on the {TP_WORLD} ranks (sha256 {ranks[0]['replicated_sha256'][:16]})")
    return [sum(out["launches_a"][i] for out in ranks) for i in range(2)]


def phase8_leg(card, backend, devices, reference, save_dir):
    """(a)-(d) over ``backend``: dp1 x tp2 with rank r on ``devices[r]``,
    then, where there are four devices, dp2 x tp2 ``train.main`` and
    single-process ``val.main`` on its best_model.pt. Returns the kernels'
    launches in the ranks' runs."""
    import json

    import torch
    from emrt_tpu_torch.models import get_model
    from emrt_tpu_torch.parallel.launch import run_ranks
    from emrt_tpu_torch.val import main as val_main
    launches = phase8_step(card, backend, devices, reference)
    leg = f"phase 8 ({backend})"
    n = TP_GRID[0] * TP_GRID[1]
    if len(devices) < n:
        print(f"{leg}: (c) dp{TP_GRID[0]} x tp{TP_GRID[1]} needs {n} devices, "
              f"{len(devices)} given: not run on this leg")
        return tuple(launches)

    t0 = time.perf_counter()
    ranks = run_ranks(tp_train_rank, n, args=(save_dir,), backend=backend, timeout=900)
    save_dir = Path(save_dir)
    grid = f"dp{TP_GRID[0]} x tp{TP_GRID[1]} on {', '.join(devices[:n])}"
    print(f"{leg}: {grid}: the ranks ran in {time.perf_counter() - t0:.1f} s")
    for r, out in enumerate(ranks):
        first, second = out["first"], out["second"]
        steps = first["steps"] + second["steps"]
        forwards = first["eval_forwards"] + second["eval_forwards"]
        flops = 2 * FLOPS_FORWARDS if r == 0 else 0       # rank 0's whole-model count
        print(f"{leg}: rank {r} (c) train.main bf16 {TRAIN_BS} rows a data rank, {TP_ITERS} + "
              f"{TP_RESUME_ITERS - TP_ITERS} iterations (--resume) in {out['train_s']:.1f} s: "
              f"window losses {[round(x, 4) for x in first['losses'] + second['losses']]}, "
              f"mIoU {first['mious'] + second['mious']}, {forwards} eval and {flops} FLOPs "
              f"forwards, launches forward/backward {out['launches']} at heads {out['heads']}, "
              f"files written {out['written']}")
        check(out["finite"], f"rank {r}: losses {first['losses'] + second['losses']}")
        check(first["last_iter"] == TP_ITERS and second["start_iter"] == TP_ITERS
              and second["last_iter"] == TP_RESUME_ITERS,
              f"rank {r}: ran to {first['last_iter']}, resumed {second['start_iter']} -> "
              f"{second['last_iter']}")
        check(tuple(out["launches"]) == (6 * (steps + forwards + flops), 6 * steps),
              f"rank {r}: launches {out['launches']} for {steps} steps, {forwards} eval and "
              f"{flops} FLOPs forwards")
        want_heads = {("fwd", HEADS // TP_GRID[1]), ("bwd", HEADS // TP_GRID[1])}
        if r == 0:
            want_heads.add(("fwd", HEADS))                  # the whole model's FLOPs count
        check(set(out["heads"]) == want_heads, f"rank {r}: kernels at heads {out['heads']}")
        check(bool(out["written"]) == (r == 0), f"rank {r} wrote {out['written']}")
        check(first["losses"] == ranks[0]["first"]["losses"]
              and second["losses"] == ranks[0]["second"]["losses"]
              and second["mious"] == ranks[0]["second"]["mious"],
              f"rank {r} logged other losses or mIoU than rank 0")
        launches = [a + b for a, b in zip(launches, out["launches"])]
    check(sorted(p.name for p in (save_dir / "checkpoints").iterdir())
          == [f"iter_{TP_RESUME_ITERS}.pt"], "checkpoints after --resume")
    cfg = _train_config()
    whole = {k: tuple(v.shape) for k, v in get_model(cfg, device="meta").state_dict().items()}
    saved = torch.load(save_dir / "checkpoints" / f"iter_{TP_RESUME_ITERS}.pt",
                       weights_only=True, map_location="cpu")
    check({k: tuple(v.shape) for k, v in saved["model"].items()} == whole,
          "the checkpoint does not hold the one-process model's tensors")
    best = json.loads((save_dir / "best_model.json").read_text())["best_miou"]
    check(best == max(ranks[0]["first"]["mious"] + ranks[0]["second"]["mious"]),
          f"best_model.json {best}")
    result = val_main(["--config", str(CONFIG), "--device", "cuda", "--model_path",
                       str(save_dir / "best_model.pt"), "DATA.DATASET", "Synthetic",
                       "TRAIN.DTYPE", "bfloat16"])
    print(f"{leg}: one-process val.main on the {grid} run's best_model.pt (whole tensors): "
          f"mIoU {result['miou']:.6f} against the run's {best:.6f}")
    check(abs(result["miou"] - best) <= F6_MIOU_TOL,
          f"val.main gives mIoU {result['miou']}, the TP run {best}")
    return tuple(launches)


def phase8_torchrun(save_dir):
    """(e) ``torchrun --standalone --nproc_per_node 2 -m emrt_tpu_torch.train
    --device cuda ... PARALLEL.MODEL 2`` for two iterations (dp1 x tp2)."""
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", str(TP_WORLD), "-m", "emrt_tpu_torch.train"]
    t0 = time.perf_counter()
    out = _run_group([*launch, "--config", str(CONFIG), "--device", "cuda", "--iters",
                      str(TP_TORCHRUN_ITERS), "DATA.DATASET", "Synthetic", "DATA.BATCH_SIZE",
                      str(TRAIN_BS), "TRAIN.DTYPE", "bfloat16", "SAVE_DIR", save_dir,
                      "PARALLEL.MODEL", str(TP_WORLD)], timeout=600)
    check(f"ranks: {TP_WORLD}" in out and f"model axis = {TP_WORLD}" in out
          and f"training done at iter {TP_TORCHRUN_ITERS}" in out,
          f"torchrun train.main PARALLEL.MODEL {TP_WORLD}:\n{out[-4000:]}")
    losses = re.findall(r"loss: ([0-9.na]+)", out)
    check(losses and all(float(x) == float(x) for x in losses), f"losses {losses}")
    print(f"phase 8 (e): torchrun --nproc_per_node {TP_WORLD} train.main --device cuda "
          f"PARALLEL.MODEL {TP_WORLD}, {TP_TORCHRUN_ITERS} iterations with a save and an "
          f"eval, in {time.perf_counter() - t0:.1f} s: losses {losses}")


def phase8(card):
    """Tensor parallelism (``emrt_tpu_torch.parallel.tensor``) on the
    flagship at full width and depth: dp1 x tp2 and dp2 x tp2 with the ranks
    on the one card over gloo, over NCCL a card a rank where there are
    cards enough; then the train CLI under torchrun. Returns the forward
    and backward launches of the ranks' runs."""
    import tempfile

    import torch
    torch.cuda.empty_cache()
    launches = (0, 0)
    n = TP_GRID[0] * TP_GRID[1]
    with tempfile.TemporaryDirectory() as tmp:
        reference = dp_reference(Path(tmp) / "reference.pt")
        legs = [("gloo", ["cuda:0"] * n)]
        if torch.cuda.device_count() >= TP_WORLD:
            legs.append(("nccl", [f"cuda:{r}" for r in range(min(n, torch.cuda.device_count()))]))
        for backend, devices in legs:
            got = phase8_leg(card, backend, devices, reference, str(Path(tmp) / backend))
            launches = tuple(a + b for a, b in zip(launches, got))
        phase8_torchrun(str(Path(tmp) / "torchrun"))
    if torch.cuda.device_count() < TP_WORLD:
        print(f"phase 8: the NCCL leg was not run: {torch.cuda.device_count()} card(s), it "
              f"needs {TP_WORLD} (and {n} for dp{TP_GRID[0]} x tp{TP_GRID[1]})")
    print(f"phase 8: K1 / K2-K3 launches in the ranks' runs: {launches}")
    return launches


# ------------------------------------------------------------- phase 9: SP

SP_WORLD = 2                             # dp1 x sp2: two ranks, 128 image rows each
SP_DROPOUT, SP_SEED = 0.1, 11            # (a): dropout on, torch seeded alike everywhere
# (a): the gradient norm before the clip against one process's: float32
# rounding through BatchNorm on batch statistics (a 1e-7 perturbation moved
# the gradients by 8.8e-4, phase 3b); dropout 0.1 moved the CPU tests' tiny
# model's norm 2e-4
SP_NORM_RTOL = 1e-3
# phase 10's control: one process's step on its images moved by one float32
# ulp of 1 (relative), otherwise the same; its norm's distance from the
# step's own is the scale of float32 rounding on that input. Where that
# scale exceeds SP_NORM_RTOL / CONTROL_FACTOR, the norm is held within
# CONTROL_FACTOR x it instead: ResNeSt-50's norm, whose gates' BatchNorm1d
# sees 8 values a channel, moved 1.1e-4 to 1.1e-2 under the control over
# five seeds, and a sound dp1 x sp2 step's gap read 0.08-2.1x its control
# where the control exceeded 2e-4 (HRNet-W48 and ResNeSt-50, seeds 0-4,
# ``--norm-seeds`` on the H100)
CONTROL_EPS, CONTROL_FACTOR = 2.0 ** -23, 5.0
# (b): the kernels' calls at the flagship's 8 heads and full token counts
SP_CALLS = [("bwd", HEADS, 110), ("bwd", HEADS, 1344), ("fwd", HEADS, 110),
            ("fwd", HEADS, 1344)]
# (d): where activations dominate: 1024^2 crops, 2 a step (bf16, output stride
# 32, so 2 divides the 32 rows at stride 32)
SP_LARGE_CROP, SP_LARGE_BS, SP_TIMED = 1024, 2, 3
# the float32 rank steps held against one process's: one more step timed
# after the checked one (the ranks share one card over gloo: a smoke figure)
GRID_TIMED = 1
SP_TORCHRUN_ITERS = 2


def _built_on(cfg, device, dtype):
    """``get_model(cfg)`` built on ``device`` itself: a rank's one thread
    takes ~6 s to initialise a ViT-L's weights on the host. Its weights
    then come from the device's generator (seeded alike by
    ``torch.manual_seed``), so a caller that compares weights loads them."""
    import torch
    from emrt_tpu_torch.models import get_model
    with torch.device(device):
        return get_model(cfg, device=device, dtype=dtype)


def _grid_step(cfg, device, init=None, dropout=None, float64=False):
    """``cfg``'s model (its weights in float64 with ``float64``) split over
    this rank's model group and sharded over its spatial group as the train
    CLI does it (``split_model_``, then ``shard_model_``; SyncBatchNorm, DDP
    over the gradient group, ``GradientSync`` over the model group) and its
    train step. Returns (model, optimizer, step, names of the split
    parameters)."""
    import torch
    from torch.nn.parallel import DistributedDataParallel
    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.parallel import convert_sync_batchnorm
    from emrt_tpu_torch.parallel.mesh import gradient_group, gradient_world
    from emrt_tpu_torch.parallel.spatial import shard_for_the_group
    from emrt_tpu_torch.parallel.tensor import split_for_the_group, splits_of
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import make_train_step
    dtype = torch.float32 if cfg.TRAIN.DTYPE == "float32" else torch.bfloat16
    model = _built_on(cfg, device, dtype)
    if init is not None:
        model.load_state_dict(init)
    if float64:
        model.double()
    _set_kernel_and_dropout(model, dropout=dropout)
    split = set(splits_of(model)) if cfg.PARALLEL.MODEL > 1 else set()
    shard_for_the_group(split_for_the_group(cfg, model))
    convert_sync_batchnorm(model)
    optimizer = get_optimizer(cfg, model, get_scheduler(cfg))
    trained = model if gradient_world() == 1 else DistributedDataParallel(
        model, device_ids=[device], broadcast_buffers=False, process_group=gradient_group(),
        find_unused_parameters=getattr(model, "ddp_find_unused_parameters", False))
    return model, optimizer, make_train_step(trained, get_loss_function(cfg), optimizer), split


def _large_batch(cfg, device, size):
    """(d)'s batch: SP_LARGE_BS synthetic crops of ``size``^2, the same on
    every rank (each keeps its rows)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(3)
    n = SP_LARGE_BS
    return {"image": torch.randn((n, 3, size, size), generator=gen, device=device),
            "label": torch.randint(0, cfg.DATA.NUM_CLASSES, (n, size, size), generator=gen,
                                   device=device)}


# (d): the regions of EMRT._forward whose activations the breakdown reads, in
# the order the forward runs them
SP_REGIONS = ("backbone", "spatial_branch", "psp_module", "model", "EFP", "cls_psp",
              "uphead", "auxlayer")


def large_step_rank(rank, world, devices, path=str(CONFIG), regions=SP_REGIONS,
                    crop=SP_LARGE_CROP):
    """Phase 9 (d) (the flagship), phase 10 (e) (the HRNet EMRT at
    ``path``) and phase 11 (d) (the transformer-backbone EMRTs) on one
    rank of dp1 x sp``world`` (one process for ``world`` 1):
    ``_measure_large_step`` of the model's bf16 steps at SP_LARGE_BS x
    ``crop``^2, reading ``regions``, its memory counted from what the
    process held before the model was built (nothing in a fresh process;
    phase 11 runs it after other steps in the same processes)."""
    import gc

    import torch
    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.parallel.mesh import model_parallel
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import make_train_step
    from emrt_tpu_torch.train.cli import spatial_rows
    device = torch.device(devices[rank])
    torch.cuda.set_device(device)
    cfg = _variant_config(path)
    cfg.DATA.CROP_SIZE = (crop, crop)
    cfg.PARALLEL.SPATIAL = world
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.manual_seed(0)
    with model_parallel(1, world):
        if world == 1:
            model = _built_on(cfg, device, torch.bfloat16)
            step = make_train_step(model, get_loss_function(cfg),
                                   get_optimizer(cfg, model, get_scheduler(cfg)))
        else:
            model, _, step, _ = _grid_step(cfg, device)
        batch = spatial_rows(model, _large_batch(cfg, device, crop))
        return _measure_large_step(model, step, batch, device, regions, base)


def _measure_large_step(model, step, batch, device, regions, base=0):
    """SP_TIMED train steps ``step(batch)`` after one warm-up, their median
    ms (CUDA events) and the peak memory allocated over them; the memory the
    model, its gradients and the optimizer's state hold before a step; and,
    in the warm-up step, the memory each of the model's ``regions`` added in
    the forward (its saved activations and outputs), in GiB; the totals
    counted above ``base`` bytes."""
    import torch
    gib = 2 ** 30
    marks = []
    hooks = [model.get_submodule(name).register_forward_hook(
        lambda *_, name=name: marks.append((name, torch.cuda.memory_allocated(device))))
        for name in regions]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    step(batch)                                        # the warm-up step
    for h in hooks:
        h.remove()
    found, last = {}, before
    for name, mem in marks:
        found[name] = found.get(name, 0.0) + (mem - last) / gib
        last = mem
    torch.cuda.synchronize()
    # the weights, gradients, momentum
    state = (torch.cuda.memory_allocated(device) - base) / gib
    torch.cuda.reset_peak_memory_stats(device)
    ms = cuda_ms(lambda: step(batch), reps=SP_TIMED, warmup=0)
    return {"ms": ms, "peak_gib": (torch.cuda.max_memory_allocated(device) - base) / gib,
            "state_gib": state, "regions": found}


def grid_step_rank(rank, world, devices, reference, grid, path=str(CONFIG), overrides=()):
    """Phase 9 (a), (b) and phase 10 (a)-(c) on one rank of dp1 x
    tp``grid[0]`` x sp``grid[1]``: one float32 step of the 8 rows at
    ``reference`` (``dp_reference`` of the same config with dropout
    SP_DROPOUT), this rank's block of their rows, with torch seeded as the
    reference was: its loss as the train CLI logs it (the gradient group's
    mean), its gradients (the split ones gathered over the model group),
    running statistics and gradient norm against the one-process step's,
    the replicated gradients' spread over the model group before
    ``GradientSync`` gave them model rank 0's, the SHA-256 of the gathered
    state and of the rank's replicated parameters after the step, its
    kernels' launches, heads and query counts, and its peak memory; then
    the ms of GRID_TIMED more steps."""
    import hashlib

    import torch
    import torch.distributed as dist
    from emrt_tpu_torch.parallel.mesh import (all_reduce_gradient, gradient_world,
                                              model_parallel)
    from emrt_tpu_torch.parallel.tensor import gather_model_state, join_tensor, shard_of, \
        splits_of
    from emrt_tpu_torch.train.cli import spatial_rows
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(devices[rank])
    torch.cuda.set_device(device)
    ref = torch.load(reference, weights_only=True)
    cfg = _variant_config(path, overrides)
    cfg.TRAIN.DTYPE = "float32"
    cfg.PARALLEL.MODEL, cfg.PARALLEL.SPATIAL = grid
    out = {"dtype": ref.get("dtype", "float32")}
    with model_parallel(*grid):
        model, optimizer, step, split = _grid_step(cfg, device, ref["init"], SP_DROPOUT,
                                                   out["dtype"] == "float64")
        if optimizer.sync is not None:
            optimizer.sync.spread = {}
        specs = splits_of(model)
        batch = spatial_rows(model, {k: v.to(device) for k, v in ref["batch"].items()})
        out["rows"] = tuple(batch["image"].shape[2:])
        calls = set()
        _record_heads(calls, queries=True)
        torch.manual_seed(ref["dropout_seed"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        _reset_counts()
        loss = step(batch)
        torch.cuda.synchronize()
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        out["launches_a"], out["calls"] = _counts(), sorted(calls)
        out["loss"] = (all_reduce_gradient(loss.clone()) / gradient_world()).item()
        out["loss_ref"] = ref["loss"]
        out["norm"], out["norm_ref"] = optimizer.grad_norm.item(), ref["norm"]
        out["norm_control"] = ref["norm_control"]
        out["spread"], out["n_spread"] = ("n/a", 0.0), 0
        if optimizer.sync is not None:
            spread = optimizer.sync.spread
            gmax = {n: p.grad.abs().max().item() for n, p in model.named_parameters()
                    if n in spread}
            top = max(gmax.values())
            held = {n: v for n, v in spread.items() if gmax[n] >= TP_SPREAD_FLOOR * top}
            out["spread"], out["n_spread"] = max(held.items(), key=lambda kv: kv[1]), len(held)
        shard, grads = shard_of(model), []
        for name, p in model.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad.contiguous()
            if name in split:
                parts = [torch.empty_like(g) for _ in range(shard.world)]
                dist.all_gather(parts, g, group=shard.group)
                g = join_tensor(parts, specs[name])
            grads.append(g.flatten())
        grads = torch.cat(grads).cpu()
        out["grad_rel"] = ((grads - ref["grads"]).norm() / ref["grads"].norm()).item()
        stats = {k: v.cpu() for k, v in model.state_dict().items() if "running" in k}
        out["stats_rel"] = max((((stats[k] - v).abs().max() / v.abs().max()).item()
                                for k, v in ref["stats"].items()), default=0.0)
        out["n_stats"], out["n_split"] = len(stats), len(split)
        out["n_stats_ref"] = len(ref["stats"])
        # a BatchNorm keeps two running statistics (the Segmenter has none)
        out["n_bn"] = sum(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                          for m in model.modules())
        out["n_replicated"] = sum(p.grad is not None for n, p in model.named_parameters()
                                  if n not in split)
        digest = hashlib.sha256()
        for value in gather_model_state(model).values():
            digest.update(value.cpu().numpy().tobytes())
        out["state_sha256"] = digest.hexdigest()
        digest = hashlib.sha256()
        for name, p in model.named_parameters():
            if name not in split:
                digest.update(p.detach().cpu().numpy().tobytes())
        out["replicated_sha256"] = digest.hexdigest()
        out["step_ms"] = cuda_ms(lambda: step(batch), reps=GRID_TIMED, warmup=0)
        del model, optimizer, step, grads
        torch.cuda.empty_cache()
    return out


def norm_tol(out) -> float:
    """The bound on ``grid_step_rank``'s gradient norm against one
    process's: SP_NORM_RTOL, or CONTROL_FACTOR x the reference's control
    where that is larger."""
    if out["norm_control"] is None:
        return SP_NORM_RTOL
    control = abs(out["norm_control"] - out["norm_ref"]) / out["norm_ref"]
    return max(SP_NORM_RTOL, CONTROL_FACTOR * control)


def grid_step_failures(out, calls, n_split=TP_SPLIT) -> list[str]:
    """The checks that ``grid_step_rank``'s result fails, its kernels'
    calls to be ``calls``; under tp also the replicated gradients' spread
    over the model group and the ``n_split`` split parameters."""
    checks = [
        (out["rows"] == (128, 256), f"a rank trained on {out['rows']} image rows x columns"),
        (abs(out["loss"] - out["loss_ref"]) <= DP_LOSS_RTOL * abs(out["loss_ref"]),
         f"loss {out['loss']} vs one process's {out['loss_ref']} (rtol {DP_LOSS_RTOL})"),
        (out["grad_rel"] <= TRAIN_BN_GRAD_RTOL,
         f"gradients differ by {out['grad_rel']} (L2, tol {TRAIN_BN_GRAD_RTOL})"),
        (out["n_stats"] == out["n_stats_ref"] == 2 * out["n_bn"]
         and out["stats_rel"] <= DP_STATS_TOL,
         f"running statistics ({out['n_stats']} tensors, one process {out['n_stats_ref']}, "
         f"{out['n_bn']} BatchNorms) "
         f"differ by {out['stats_rel']} x max (tol {DP_STATS_TOL})"),
        (abs(out["norm"] - out["norm_ref"]) <= norm_tol(out) * out["norm_ref"],
         f"gradient norm {out['norm']} vs one process's {out['norm_ref']} "
         f"(rtol {norm_tol(out):.3e})"),
        (tuple(out["launches_a"]) == ((6, 6) if calls else (0, 0)),
         f"a step launched forward/backward {out['launches_a']}"),
        (out["calls"] == calls, f"the kernels ran as {out['calls']}, not {calls} "
                                f"(kind, heads, queries)")]
    if out["n_split"]:
        # most replicated gradients held: more than 300 (of the flagship's
        # 362, ViT-L EMRT's 431), or five in six of a model with fewer
        # (SETR-PUP-L's 272)
        checks += [(out["n_spread"] > min(300, 5 * out["n_replicated"] // 6)
                    and out["spread"][1] <= TP_SPREAD_TOL,
                    f"the replicated gradient {out['spread'][0]} differs over the model group "
                    f"by {out['spread'][1]} x its max (tol {TP_SPREAD_TOL})"),
                   (out["n_split"] == n_split,
                    f"{out['n_split']} split parameters, not {n_split}")]
    return [what for ok, what in checks if not ok]


def phase9_step(backend, devices, reference):
    """(a) and (b) over ``backend``: dp1 x sp2 with rank r on ``devices[r]``.
    Returns the kernels' launches in the ranks' (a) steps."""
    from emrt_tpu_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(grid_step_rank, SP_WORLD,
                      args=(devices[:SP_WORLD], reference, (1, SP_WORLD)), backend=backend,
                      timeout=900)
    leg = f"phase 9 ({backend})"
    print(f"{leg}: dp1 x sp{SP_WORLD} on {', '.join(devices[:SP_WORLD])}: the ranks ran in "
          f"{time.perf_counter() - t0:.1f} s")
    for r, out in enumerate(ranks):
        print(f"{leg}: rank {r} (a) float32 dp1 x sp{SP_WORLD} step of 8 x {out['rows']} "
              f"rows x columns, dropout {SP_DROPOUT}: loss {out['loss']:.9g} against one "
              f"process's {out['loss_ref']:.9g} (rtol {DP_LOSS_RTOL}); gradients |sp-one|/|one| "
              f"(L2) {out['grad_rel']:.3e} (tol {TRAIN_BN_GRAD_RTOL}); BatchNorm running "
              f"statistics within {out['stats_rel']:.3e} x max (tol {DP_STATS_TOL}); gradient "
              f"norm before the clip {out['norm']:.9g} against {out['norm_ref']:.9g} (rtol "
              f"{SP_NORM_RTOL}); (b) launches forward/backward {out['launches_a']}, calls "
              f"(kind, heads, queries) {out['calls']}")
        failures = grid_step_failures(out, SP_CALLS)
        check(not failures, f"rank {r}: {'; '.join(failures)}")
    check(len({out["state_sha256"] for out in ranks}) == 1,
          "the ranks' parameters and buffers differ after the dropout step")
    print(f"{leg}: (a) after the step the parameters and buffers are bitwise equal on the "
          f"{SP_WORLD} ranks (sha256 {ranks[0]['state_sha256'][:16]})")
    return tuple(sum(out["launches_a"][i] for out in ranks) for i in range(2))


def large_step_memory(card, leg, backend, devices):
    """Phase 9 (d): one process's bf16 step of the flagship at SP_LARGE_BS x
    SP_LARGE_CROP^2 and a dp1 x sp2 rank's, each in fresh processes on
    ``devices`` over ``backend``; prints their times, peak memory and
    breakdown (``report_large_step``). Returns the ratio of the peaks."""
    from emrt_tpu_torch.parallel.launch import run_ranks
    one = run_ranks(large_step_rank, 1, args=(devices[:1],), backend=backend, timeout=600)[0]
    ranks = run_ranks(large_step_rank, SP_WORLD, args=(devices[:SP_WORLD],), backend=backend,
                      timeout=600)
    return report_large_step(card, leg, one, ranks, SP_LARGE_CROP, devices)


def report_large_step(card, leg, one, ranks, crop, devices):
    """Print ``large_step_rank``'s readings of one process (``one``) and of
    the dp1 x sp2 ``ranks`` on ``devices``; returns the ratio of the
    peaks."""
    note = ("the ranks share one card over gloo: agreement and memory figures, not scaling"
            if len(set(devices[:SP_WORLD])) == 1 else "one card a rank")
    for who, out in [("one process", one)] + [(f"rank {r}", o) for r, o in enumerate(ranks)]:
        found = ", ".join(f"{k} {v:.3f}" for k, v in out["regions"].items())
        print(f"{leg} {who}: bf16 step of {SP_LARGE_BS} x {crop}^2 crops"
              f"{'' if who == 'one process' else f' ({crop // SP_WORLD} rows a rank)'}: "
              f"{out['ms']:.2f} ms (median of {SP_TIMED}, CUDA events), peak memory "
              f"{out['peak_gib']:.3f} GiB, of which weights, gradients and optimizer state "
              f"{out['state_gib']:.3f}; the forward's activations by region (GiB): {found} "
              f"({card}{'' if who == 'one process' else '; ' + note})")
    peak = max(out["peak_gib"] for out in ranks)
    print(f"{leg}: peak memory a rank / one process's: {peak / one['peak_gib']:.3f} "
          f"({peak:.3f} / {one['peak_gib']:.3f} GiB; {card})")
    return peak / one["peak_gib"]


def phase9_torchrun(save_dir):
    """(c) ``torchrun --standalone --nproc_per_node 2 -m emrt_tpu_torch.train
    --device cuda ... PARALLEL.SPATIAL 2`` for two iterations with a save
    and an eval, then one-process ``val.main`` on its best_model.pt against
    the run's mIoU."""
    _torchrun_and_val(save_dir, "phase 9 (c)", SP_WORLD, SP_TORCHRUN_ITERS,
                      ["PARALLEL.SPATIAL", str(SP_WORLD)], [f"spatial axis = {SP_WORLD}"])


def _torchrun_and_val(save_dir, leg, nproc, iters, opts, logged):
    """``torchrun --standalone --nproc_per_node nproc -m emrt_tpu_torch.train
    --device cuda ...`` on the flagship with the config overrides ``opts``
    for ``iters`` iterations with a save and an eval (its log must hold the
    strings ``logged``), then one-process ``val.main`` on its best_model.pt
    against the run's mIoU."""
    import json

    from emrt_tpu_torch.val import main as val_main
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", str(nproc), "-m", "emrt_tpu_torch.train"]
    t0 = time.perf_counter()
    out = _run_group([*launch, "--config", str(CONFIG), "--device", "cuda", "--iters",
                      str(iters), "--seed", "0", "DATA.DATASET", "Synthetic",
                      "DATA.BATCH_SIZE", str(TRAIN_BS), "TRAIN.DTYPE", "bfloat16",
                      "SAVE_DIR", save_dir, "LOGGING_INFO_FREQ", "1", *opts], timeout=600)
    check(f"ranks: {nproc}" in out and all(x in out for x in logged)
          and f"training done at iter {iters}" in out,
          f"torchrun train.main {' '.join(opts)}:\n{out[-4000:]}")
    losses = re.findall(r"loss: ([0-9.na]+)", out)
    check(len(losses) == iters and all(float(x) == float(x) for x in losses),
          f"losses {losses}")
    best = json.loads((Path(save_dir) / "best_model.json").read_text())["best_miou"]
    result = val_main(["--config", str(CONFIG), "--device", "cuda", "--model_path",
                       str(Path(save_dir) / "best_model.pt"), "DATA.DATASET", "Synthetic",
                       "TRAIN.DTYPE", "bfloat16"])
    print(f"{leg}: torchrun --nproc_per_node {nproc} train.main --device cuda "
          f"{' '.join(opts)}, {iters} iterations with a save and an eval, in "
          f"{time.perf_counter() - t0:.1f} s: losses {losses}; one-process val.main on its "
          f"best_model.pt: mIoU {result['miou']:.6f} against the run's {best:.6f}")
    check(abs(result["miou"] - best) <= F6_MIOU_TOL,
          f"val.main gives mIoU {result['miou']}, the run {best}")


def phase9(card, torchrun=True):
    """Spatial parallelism (``emrt_tpu_torch.parallel.spatial``) on the
    flagship at full width and depth: dp1 x sp2 with the ranks on the one
    card over gloo, over NCCL a card a rank where there are two; then the
    train CLI under torchrun and ``val.main`` on its checkpoint. Returns the
    forward and backward launches of the ranks' (a) steps."""
    import tempfile

    import torch
    torch.cuda.empty_cache()
    launches = (0, 0)
    with tempfile.TemporaryDirectory() as tmp:
        reference = dp_reference(Path(tmp) / "reference.pt", dropout=SP_DROPOUT)
        legs = [("gloo", ["cuda:0"] * SP_WORLD)]
        if torch.cuda.device_count() >= SP_WORLD:
            legs.append(("nccl", [f"cuda:{r}" for r in range(SP_WORLD)]))
        for backend, devices in legs:
            got = phase9_step(backend, devices, reference)
            launches = tuple(a + b for a, b in zip(launches, got))
            large_step_memory(card, f"phase 9 ({backend}) (d)", backend, devices)
        if torchrun:
            phase9_torchrun(str(Path(tmp) / "torchrun"))
    if torch.cuda.device_count() < SP_WORLD:
        print(f"phase 9: the NCCL leg was not run: {torch.cuda.device_count()} card(s), it "
              f"needs {SP_WORLD}")
    print(f"phase 9: K1 / K2-K3 launches in the ranks' (a) steps: {launches}")
    return launches


# ------------------------------------------------------- phase 10: TP x SP

TPSP_GRID = (2, 2)                       # (a), (d): dp1 x tp2 x sp2 (model, spatial)
TPSP_WORLD = TPSP_GRID[0] * TPSP_GRID[1]
# (a): the kernels' calls of a rank: 4 heads (tp2), the full token counts
TPSP_CALLS = [("bwd", HEADS // TPSP_GRID[0], 110), ("bwd", HEADS // TPSP_GRID[0], 1344),
              ("fwd", HEADS // TPSP_GRID[0], 110), ("fwd", HEADS // TPSP_GRID[0], 1344)]
HRNET_YAML = ROOT / "configs" / "EMRT" / "EMRT_256x256_160k_potsdam_hrnet.yaml"
# (b): dp1 x sp2 of the other convolutional backbones: (name, yaml, config
# overrides, the encoder's queries at 256^2, 8 heads)
SP_BACKBONES = (("HRNet-W48", HRNET_YAML, {}, 3072),
                ("ResNeSt-50", CONFIG, {"MODEL.ENCODER.TYPE": "resnest50"}, 1344))
# (e): the HRNet EMRT's regions, as phase 9 (d) reads the flagship's
HRNET_REGIONS = ("backbone", "input_proj.0", "input_proj.1", "input_proj.2", "spatial_branch",
                 "psp_module", "model", "EFP", "cls_psp", "uphead", "auxlayer")
TPSP_TORCHRUN_ITERS = 2
NORM_SEEDS = (0, 1, 2, 3, 4)             # ``--norm-seeds``: (b) from each


def phase10_step(card, what, reference, grid, calls, path=str(CONFIG), overrides=(),
                 strict=True, n_split=TP_SPLIT):
    """Phase 10 (a), (b) and phase 11 (b) (``what``): ``grid`` = (model,
    spatial) ranks on the first card over gloo, each rank's step against
    ``reference``'s (a ``dp_reference`` with its control), reported by
    ``report_grid_step``. Returns the launches of the ranks' steps and the
    failures."""
    from emrt_tpu_torch.parallel.launch import run_ranks
    n = grid[0] * grid[1]
    t0 = time.perf_counter()
    ranks = run_ranks(grid_step_rank, n, args=(["cuda:0"] * n, reference, grid, str(path),
                                               overrides), timeout=900)
    return report_grid_step(card, what, ranks, grid, calls, time.perf_counter() - t0, strict,
                            n_split)


def report_grid_step(card, what, ranks, grid, calls, seconds=None, strict=True,
                     n_split=TP_SPLIT):
    """Print ``grid_step_rank``'s readings on each of ``ranks`` (a grid of
    (model, spatial) ranks on the first card, run in ``seconds``), then fail
    on the checks that any rank failed (with ``strict`` False return them
    instead). Returns the launches of the ranks' steps and the failures."""
    n = grid[0] * grid[1]
    devices = ["cuda:0"] * n
    tag = f"dp1 x tp{grid[0]} x sp{grid[1]}" if grid[0] > 1 else f"dp1 x sp{grid[1]}"
    ran = "" if seconds is None else f": the ranks ran in {seconds:.1f} s"
    print(f"{what}: {tag} on {', '.join(devices)} (the ranks share one card over "
          f"gloo: an agreement figure, not scaling; {card}){ran}")
    for r, out in enumerate(ranks):
        spread = (f"; largest spread of {out['n_spread']} replicated gradients over the model "
                  f"group before the overwrite {out['spread'][1]:.3e} x max ({out['spread'][0]}, "
                  f"tol {TP_SPREAD_TOL}); {out['n_split']} split parameters"
                  if out["n_split"] else "")
        print(f"{what}: rank {r} {out['dtype']} step of 8 x {out['rows']} rows x columns, "
              f"dropout {SP_DROPOUT}: loss {out['loss']:.9g} against one process's "
              f"{out['loss_ref']:.9g} (rtol {DP_LOSS_RTOL}); gradients |grid-one|/|one| (L2) "
              f"{out['grad_rel']:.3e} (tol {TRAIN_BN_GRAD_RTOL}); BatchNorm running statistics "
              f"within {out['stats_rel']:.3e} x max (tol {DP_STATS_TOL}); gradient norm before "
              f"the clip {out['norm']:.9g} against {out['norm_ref']:.9g}, "
              f"{abs(out['norm'] - out['norm_ref']) / out['norm_ref']:.3e} apart (rtol "
              f"{norm_tol(out):.3e}; one process's control, its images moved by "
              f"{CONTROL_EPS:.3g}: "
              f"{abs(out['norm_control'] - out['norm_ref']) / out['norm_ref']:.3e} apart)"
              f"{spread}; (c) launches forward/backward {out['launches_a']}, calls (kind, "
              f"heads, queries) {out['calls']}")
    failures = [f"{what} rank {r}: {f}" for r, out in enumerate(ranks)
                for f in grid_step_failures(out, calls, n_split)]
    if len({out["state_sha256"] for out in ranks}) != 1:
        failures.append(f"{what}: the ranks' gathered states differ after the step")
    if len({out["replicated_sha256"] for out in ranks}) != 1:
        failures.append(f"{what}: the ranks' replicated parameters differ after the "
                        f"step")
    if strict:
        check(not failures, "; ".join(failures))
    print(f"{what}: after the dropout step the gathered states and the replicated "
          f"parameters are bitwise equal on the {n} ranks (sha256 "
          f"{ranks[0]['state_sha256'][:16]}, {ranks[0]['replicated_sha256'][:16]})")
    step_ms = ", ".join(f"{out['step_ms']:.2f}" for out in ranks)
    peaks = ", ".join(f"{out['peak_gib']:.3f}" for out in ranks)
    print(f"{what}: {ranks[0]['dtype']} steps a rank {step_ms} ms (median of {GRID_TIMED}, CUDA "
          f"events), peak memory {peaks} GiB ({card}; the ranks share one card over gloo: "
          f"not a scaling figure)")
    return tuple(sum(out["launches_a"][i] for out in ranks) for i in range(2)), failures


def _backbone_reference(tmp, name, path, pairs=(), seed=0):
    """The ``dp_reference`` (dropout SP_DROPOUT, with its control; in float64
    for SP_FLOAT64's models) of the model at ``path`` with config ``pairs``
    from ``seed``, made once under ``tmp``; returns its path."""
    reference = Path(tmp) / f"{name} seed {seed}.pt"
    if not reference.exists():
        dp_reference(reference, dropout=SP_DROPOUT, cfg=_variant_config(path, pairs), seed=seed,
                     control=True, dtype="float64" if name in SP_FLOAT64 else "float32")
    return str(reference)


def _encoder_calls(heads, len_q):
    """The kernels' calls of one EMRT step: the decoder's at 110 queries and
    the encoder's at ``len_q``, forward and backward, at ``heads``; none for
    a zoo model (``len_q`` None), which runs no deformable attention."""
    if len_q is None:
        return []
    return [("bwd", heads, 110), ("bwd", heads, len_q), ("fwd", heads, 110),
            ("fwd", heads, len_q)]


def phase10_backbone(card, tmp, name, path, overrides, len_q, seed=0, strict=True,
                     what="phase 10 (b)", grid=(1, SP_WORLD), n_split=TP_SPLIT):
    """Phase 10 (b) for one of SP_BACKBONES and phase 11 (b) for ViT-L, its
    weights, batch and dropout from ``seed``: ``phase10_step`` at dp1 x
    tp``grid[0]`` x sp``grid[1]`` against one process's step, its encoder's
    calls at ``len_q`` queries and 8 / ``grid[0]`` heads."""
    pairs = tuple(overrides.items())
    reference = _backbone_reference(tmp, name, path, pairs, seed)
    tag = f"{what} {name}" + (f" seed {seed}" if seed else "")
    return phase10_step(card, tag, reference, grid, _encoder_calls(HEADS // grid[0], len_q),
                        path, pairs, strict, n_split)


def calls_rank(rank, world, calls):
    """``fn(rank, world, *args)`` for each (fn, args) of ``calls`` in turn:
    one start of the ranks for them all (a start of two ranks cost 20-25 s
    on the H100 machine's shared host)."""
    return [fn(rank, world, *args) for fn, args in calls]


def sharded_steps(card, what, tmp, steps, memory):
    """Phase 10 (b), (e) and phases 11-13 (a), (d) (``what``): the dp1 x sp2
    step of each of ``steps`` ((tag, name, yaml, config pairs, the encoder's
    queries)) against one process's (``_backbone_reference`` under ``tmp``;
    ``report_grid_step``), then the bf16 memory step of each of ``memory``
    ((tag, name, yaml, regions, crop)) on the same two ranks, all in one
    start of them; then each memory step's one process, all in one process
    (``report_large_step``; each counted from what its process held before
    it). Returns the launches of each checked step and the memory ratios by
    name."""
    from emrt_tpu_torch.parallel.launch import run_ranks
    devices = ["cuda:0"] * SP_WORLD
    jobs = [(grid_step_rank, (devices, _backbone_reference(tmp, name, path, pairs),
                              (1, SP_WORLD), str(path), pairs))
            for _, name, path, pairs, _ in steps]
    large = [(str(path), regions, crop) for _, _, path, regions, crop in memory]
    t0 = time.perf_counter()
    ranks = run_ranks(calls_rank, SP_WORLD, args=(
        jobs + [(large_step_rank, (devices, *args)) for args in large],), timeout=1800)
    print(f"{what}: dp1 x sp{SP_WORLD} on {', '.join(devices)}: the ranks ran the "
          f"{len(jobs)} checked steps and the {len(large)} memory steps in "
          f"{time.perf_counter() - t0:.1f} s")
    launches = [report_grid_step(card, f"{tag} {name}", [r[i] for r in ranks], (1, SP_WORLD),
                                 _encoder_calls(HEADS, len_q))[0]
                for i, (tag, name, _, _, len_q) in enumerate(steps)]
    ratios = {}
    if large:
        ones = run_ranks(calls_rank, 1, args=(
            [(large_step_rank, (devices[:1], *args)) for args in large],), timeout=1200)[0]
        for i, ((tag, name, *_), (_, _, crop)) in enumerate(zip(memory, large)):
            ratios[name] = report_large_step(card, f"{tag} {name}", ones[i],
                                             [r[len(jobs) + i] for r in ranks], crop, devices)
    return launches, ratios


def tpsp_steps(card, tmp, steps):
    """Phases 11-13 (b): the dp1 x tp2 x sp2 step of each of ``steps``
    ((tag, name, yaml, config pairs, the encoder's queries, its split
    parameters)) against one process's (``_backbone_reference`` under
    ``tmp``), all in one start of the four ranks, with phase 10 (a)'s checks
    (``report_grid_step``). Returns the launches of each step."""
    from emrt_tpu_torch.parallel.launch import run_ranks
    n = TPSP_GRID[0] * TPSP_GRID[1]
    devices = ["cuda:0"] * n
    jobs = [(grid_step_rank, (devices, _backbone_reference(tmp, name, path, pairs), TPSP_GRID,
                              str(path), pairs)) for _, name, path, pairs, _, _ in steps]
    t0 = time.perf_counter()
    ranks = run_ranks(calls_rank, n, args=(jobs,), timeout=1800)
    seconds = time.perf_counter() - t0
    return [report_grid_step(card, f"{tag} {name}", [r[i] for r in ranks], TPSP_GRID,
                             _encoder_calls(HEADS // TPSP_GRID[0], len_q), seconds,
                             n_split=n_split)[0]
            for i, (tag, name, _, _, len_q, n_split) in enumerate(steps)]


def _total(launches):
    """The sum of (forward, backward) launch pairs."""
    return tuple(sum(pair[i] for pair in launches) for i in range(2))


def phase10_torchrun(save_dir):
    """(d) ``torchrun --standalone --nproc_per_node 4 -m emrt_tpu_torch.train
    --device cuda ... PARALLEL.MODEL 2 PARALLEL.SPATIAL 2`` for two
    iterations with a save and an eval, then one-process ``val.main`` on its
    best_model.pt against the run's mIoU."""
    _torchrun_and_val(save_dir, "phase 10 (d)", TPSP_WORLD, TPSP_TORCHRUN_ITERS,
                      ["PARALLEL.MODEL", str(TPSP_GRID[0]), "PARALLEL.SPATIAL",
                       str(TPSP_GRID[1])],
                      [f"model axis = {TPSP_GRID[0]}", f"spatial axis = {TPSP_GRID[1]}"])


def phase10(card, torchrun=True):
    """Tensor x spatial parallelism on the flagship, and spatial parallelism
    of the HRNet and ResNeSt EMRTs, at full width and depth with seeded
    weights, the ranks on the one card over gloo: (a) dp1 x tp2 x sp2 and
    (b) dp1 x sp2 steps against one process's, (c) their kernels' launches,
    (d) the train CLI under torchrun and ``val.main`` on its checkpoint,
    (e) the HRNet EMRT's peak memory a rank. Returns the forward and
    backward launches of the ranks' steps and (e)'s ratio."""
    import tempfile

    import torch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        reference = dp_reference(Path(tmp) / "flagship.pt", dropout=SP_DROPOUT, control=True)
        launches, _ = phase10_step(card, "phase 10 (a)", reference, TPSP_GRID, TPSP_CALLS)
        got, ratios = sharded_steps(
            card, "phase 10 (b), (e)", tmp,
            [("phase 10 (b)", name, path, tuple(overrides.items()), len_q)
             for name, path, overrides, len_q in SP_BACKBONES],
            [("phase 10 (e)", "HRNet-W48 EMRT", HRNET_YAML, HRNET_REGIONS, SP_LARGE_CROP)])
        launches = _total([launches, *got])
        ratio = ratios["HRNet-W48 EMRT"]
        if torchrun:
            phase10_torchrun(str(Path(tmp) / "torchrun"))
    print(f"phase 10: K1 / K2-K3 launches in the ranks' steps: {launches}")
    return launches, ratio


# --------------------------------------- phase 11: SP of the transformer EMRTs

# (a): dp1 x sp2 of the paper's transformer-backbone EMRTs: (name, yaml, the
# encoder's queries at 256^2, (d)'s crop, (d)'s regions). ViT-L's (d) crop is
# 768: one process's attention rows alone would take ~77 GB at 2 x 1024^2
# (and the EMRT trains at no batch of 1: the pyramid pooling's 1 x 1 map has
# one value a channel for its BatchNorm)
TAPS_REGIONS = ("encoder",) + SP_REGIONS[1:]
SP_TRANSFORMERS = (
    ("CSwin", ROOT / "configs" / "EMRT" / "EMRT_cswin_256x256_160k_potsdam.yaml", 1344, 1024,
     TAPS_REGIONS),
    ("ViT-L", ROOT / "configs" / "EMRT" / "EMRT_vit_256x256_160k_potsdam.yaml", 768, 768,
     TAPS_REGIONS),
    ("SegFormer-B4", ROOT / "configs" / "EMRT" / "EMRT_segformerb4_256x256_160k_potsdam.yaml",
     1344, 1024, SP_REGIONS))
# (b): ViT-L's split parameters under tp2: the flagship's and 3 in each of its
# 24 attentions (qkv weight and bias, the output projection's weight)
VIT_SPLIT = TP_SPLIT + 24 * 3
# the whole script's depth cut of (a) and (b) (``--transformer-sp`` runs them
# at full depth), to make room for phase 12 in its time limit: CSwin two blocks
# in stage 3 (of 21), ViT-L two layers a tap (8 of 24; (b)'s split parameters
# then the flagship's and 3 in each of 8 attentions)
DEPTH_CUT = {"CSwin": (("MODEL.TRANS.STAGE_DEPTHS", "(1, 2, 2, 1)"),),
             "ViT-L": (("MODEL.TRANS.NUM_LAYERS", "8"),
                       ("MODEL.ENCODER.OUT_INDICES", "(1, 3, 5, 7)"))}
VIT_CUT_SPLIT = TP_SPLIT + 8 * 3


def phase11_specs(cut):
    """Phase 11's checked steps, memory steps and tp x sp steps (as
    ``sharded_steps`` and ``tpsp_steps`` take them): (a) each of
    SP_TRANSFORMERS' dp1 x sp2 steps and (b) ViT-L's dp1 x tp2 x sp2 step at
    full depth or, with ``cut``, at DEPTH_CUT's, (d) their bf16 peak memory a
    rank at full depth."""
    depth = (lambda name: DEPTH_CUT.get(name, ())) if cut else (lambda name: ())
    name, path, len_q, _, _ = SP_TRANSFORMERS[1]
    return ([("phase 11 (a)", name, path, depth(name), len_q)
             for name, path, len_q, *_ in SP_TRANSFORMERS],
            [("phase 11 (d)", f"{name} EMRT", path, regions, crop)
             for name, path, _, crop, regions in SP_TRANSFORMERS],
            [("phase 11 (b)", name, path, depth(name), len_q,
              VIT_CUT_SPLIT if cut else VIT_SPLIT)])


# ------------------------------ phase 12: SP of the zoo's global-attention models

ZOO_SP_CROP = (("DATA.CROP_SIZE", "(256, 256)"),)
# a clip of 1.0 where the yaml sets none (SETR-MLA's and SegFormer's ADE20K
# yamls), so that the optimizer computes the gradient norm the checks read
ZOO_SP_CLIP = ZOO_SP_CROP + (("TRAIN.OPTIMIZER.GRAD_CLIP", "1.0"),)
# (a): dp1 x sp2 of the zoo's global-attention models at full width and depth,
# at 256^2 (phase 7's 8 rows): (name, yaml under configs/, config pairs); SETR-PUP-L
# at its yaml's own crop, the others built at the crop overridden (their
# position tables with it)
SP_ZOO = (
    ("SETR-PUP-L", "setr/SETR_PUP_Large_256x256_160k_potsdam_bs_8.yaml", ()),
    ("SETR-MLA-L", "setr/SETR_MLA_Large_512x512_160k_ade20k.yaml", ZOO_SP_CLIP),
    ("DPT-L project", "dpt/DPT_Large_512x512_160k_potsdam_bs_8.yaml", ZOO_SP_CROP),
    ("Segmenter ViT-L mask", "segmenter/segmenter_Large_512x512_160k_ade20k_bs_16.yaml",
     ZOO_SP_CROP),
    ("Segmenter DeiT-B distilled mask",
     "segmenter/segmenter_base_distilled_512x512_160k_ade20k_bs_16.yaml", ZOO_SP_CROP),
    ("SegFormer-B5", "segformer/segformer_b5_512x512_160k_ade20k.yaml", ZOO_SP_CLIP))
# (b): SETR-PUP-L's split parameters under tp2: 3 in each of its 24 attentions
SETR_SPLIT = 24 * 3
# the whole script's depth cut of (a) and (b) (``--zoo-sp`` runs them at full
# depth), to make room for phase 13 in its time limit: the ViT-L encoders at 8
# of their 24 layers, their taps spread over them ((b)'s split parameters then
# 3 in each of 8 attentions), DeiT-B at 4 of its 12, SegFormer-B5's third
# stage at 8 of its 40 blocks
ZOO_DEPTH_CUT = {**{name: (("MODEL.TRANS.NUM_LAYERS", "8"),
                           ("MODEL.ENCODER.OUT_INDICES", "(7,)" if "Segmenter" in name
                            else "(1, 3, 5, 7)"))
                    for name in ("SETR-PUP-L", "SETR-MLA-L", "DPT-L project",
                                 "Segmenter ViT-L mask")},
                 "Segmenter DeiT-B distilled mask": (("MODEL.TRANS.NUM_LAYERS", "4"),
                                                     ("MODEL.ENCODER.OUT_INDICES", "(3,)")),
                 "SegFormer-B5": (("MODEL.TRANS.STAGE_DEPTHS", "(3, 6, 8, 3)"),)}
SETR_CUT_SPLIT = 8 * 3
# (d): SETR-PUP-L's bf16 memory step at the cityscapes yaml's 768^2 crop, 2 a
# step (the yaml's batch of 8 one card holds neither whole nor in two ranks),
# and the regions whose activations it reads
SETR_768 = ROOT / "configs" / "setr" / "SETR_PUP_Large_768x768_80k_cityscapes.yaml"
SETR_REGIONS = ("encoder", "decoder", "aux_decoder2", "aux_decoder3", "aux_decoder4",
                "aux_decoder5")

# ------------------------------ phase 13: SP of UperNet, Trans2Seg and FCN

# (a): dp1 x sp2 of the rest of the zoo at full width and depth, at 256^2:
# UperNet with each backbone from its Potsdam yaml (512^2, built at the 256
# crop), Trans2Seg-medium and FCN-R50c at output stride 8 (no yaml names FCN:
# the flagship's ResNet yaml with MODEL.NAME FCN, as the zoo builds it)
FCN_OS8 = (("MODEL.NAME", "FCN"), ("MODEL.ENCODER.TYPE", "resnet50c"),
           ("MODEL.OUTPUT_STRIDE", "8"))
UPERNET_SWIN = "upernet_swin/upernet_swin_tiny_patch4_windown7_512x512_160k_potsdam.yaml"
TRANS2SEG = "trans2seg/Trans2Seg_medium_256x256_160k_potsdam.yaml"
SP_ZOO_REST = (
    ("UperNet-Swin-T", UPERNET_SWIN, ZOO_SP_CROP),
    ("UperNet-CSwin-T", "upernet_cswin/upernet_cswin_tiny_patch4_512x512_160k_potsdam.yaml",
     ZOO_SP_CROP),
    ("UperNet-Focal-B",
     "upernet_focal/upernet_focal_base_patch4_windown7_512x512_160k_potsdam.yaml", ZOO_SP_CROP),
    ("Trans2Seg-medium", TRANS2SEG, ()),
    ("FCN-R50c OS8", "EMRT/EMRT_256x256_160k_potsdam.yaml", FCN_OS8))
# the ResNet-50c models' steps run in float64, as their CPU tests do: in
# float32 their BatchNorms amplify the rounding of the halo strips' convs
# past what the norm's control bounds (Trans2Seg: the norm 2.731e-03 apart
# against a control of 1.856e-04)
SP_FLOAT64 = ("Trans2Seg-medium", "FCN-R50c OS8")
# (b): Trans2Seg-medium's split parameters under tp2: 2 in each of its 4
# encoder attentions (the bias-free qkv's weight, the projection's weight)
TRANS2SEG_SPLIT = 4 * 2
# (d): UperNet-Swin-T's bf16 memory step at 2 x 1024^2 and its regions (the
# four stage LayerNorms run between ``encoder`` and ``decoder``: their maps
# count in the decoder's share)
UPERNET_REGIONS = ("encoder", "decoder", "aux_decoder")


def phase12_specs(cut):
    """Phases 12 and 13's checked steps, memory steps and tp x sp steps (as
    ``sharded_steps`` and ``tpsp_steps`` take them). Phase 12, the
    global-attention models (SETR, DPT, the Segmenter, SegFormer: the whole
    model on a rank's rows): (a) each of SP_ZOO's dp1 x sp2 f32 steps, (b)
    SETR-PUP-L's dp1 x tp2 x sp2 step, at full depth or, with ``cut``,
    ZOO_DEPTH_CUT's; (d) SETR-PUP-L's bf16 peak memory a rank at 2 x 768^2.
    Phase 13, UperNet (Swin, CSwin, Focal), Trans2Seg and FCN: (a) each of
    SP_ZOO_REST's dp1 x sp2 steps (SP_FLOAT64's in float64), (b)
    Trans2Seg's dp1 x tp2 x sp2 step, (d) UperNet-Swin-T's bf16 peak memory
    a rank at 2 x 1024^2, all at full depth."""
    configs = ROOT / "configs"
    depth = (lambda name: ZOO_DEPTH_CUT.get(name, ())) if cut else (lambda name: ())
    name, yaml, pairs = SP_ZOO[0]
    return ([("phase 12 (a)", name, configs / yaml, pairs + depth(name), None)
             for name, yaml, pairs in SP_ZOO]
            + [("phase 13 (a)", name, configs / yaml, pairs, None)
               for name, yaml, pairs in SP_ZOO_REST],
            [("phase 12 (d)", "SETR-PUP-L", SETR_768, SETR_REGIONS, 768),
             ("phase 13 (d)", "UperNet-Swin-T", configs / UPERNET_SWIN, UPERNET_REGIONS,
              SP_LARGE_CROP)],
            [("phase 12 (b)", name, configs / yaml, pairs + depth(name), None,
              SETR_CUT_SPLIT if cut else SETR_SPLIT),
             ("phase 13 (b)", "Trans2Seg-medium", configs / TRANS2SEG, (), None,
              TRANS2SEG_SPLIT)])


def sp_phases(card, phases, cut=False):
    """Spatial parallelism at full width with seeded weights, the ranks on
    the one card over gloo, of phase 11 (the transformer-backbone EMRTs)
    and of phases 12-13 (the zoo) (``phases``: ``phase11_specs``,
    ``phase12_specs``), their (a) and (d) rank steps in one start of the two
    ranks, their (d) one-process steps in one process, their (b) steps in
    one start of the four ranks: a start costs ~15-25 s on the card's
    shared host. (c): phase 11's steps launch K1 and the backward 6 / 6
    times each (``grid_step_failures``), the zoo's 0 / 0. Returns each
    phase's launches (phases 12 and 13 as one) and (d)'s ratios by name."""
    import tempfile

    import torch
    torch.cuda.empty_cache()
    specs = [spec(cut) for spec in phases]
    steps, memory, tpsp = ([item for spec in specs for item in spec[i]] for i in range(3))
    what = " and ".join("phase 11" if spec is phase11_specs else "phases 12-13"
                        for spec in phases)
    with tempfile.TemporaryDirectory() as tmp:
        launches, ratios = sharded_steps(card, f"{what} (a), (d)", tmp, steps, memory)
        launches += tpsp_steps(card, tmp, tpsp)
    tags = [tag for tag, *_ in steps] + [tag for tag, *_ in tpsp]
    by_phase = {11: _total([n for t, n in zip(tags, launches) if t.startswith("phase 11")]),
                12: _total([n for t, n in zip(tags, launches) if not t.startswith("phase 11")])}
    if phase12_specs in phases:
        check(by_phase[12] == (0, 0), f"phases 12-13 (c): the zoo's rank steps launched K1 / "
                                      f"K2-K3 {by_phase[12]} times")
    print(f"{what} (c): K1 / K2-K3 launches in the ranks' steps (phase 11; phases 12-13)"
          f"{' (depth cut)' if cut else ''}: {by_phase[11]}; {by_phase[12]}")
    return by_phase, ratios


_CATEGORIES = (   # (category, substrings of a kernel's name), first match wins
    ("K1 deformable fwd", ("ms_deform_attn_fwd",)),
    ("K2+K3 deformable bwd (fused)", ("ms_deform_attn_bwd",)),
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw")),
    ("layer / group norm", ("layer_norm", "group_norm", "GammaBeta", "RowwiseMoments",
                            "FusedParams")),
    ("convolution (cuDNN, incl. layout transposes)",
     ("conv", "cudnn", "implicit", "dgrad", "wgrad", "fprop", "nchwToNhwc", "nhwcToNchw")),
    ("matmul (cuBLAS)", ("gemm", "cublas", "cutlass", "xmma")),
    ("bilinear resize", ("upsample",)),
    ("pooling", ("pool",)),
    ("gather / scatter / index", ("gather", "scatter", "index", "embedding")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("reduction", ("reduce",)),
    ("softmax / log-softmax", ("softmax",)),
    ("elementwise (incl. casts, copies, fills)", ("elementwise",)),
    ("memcpy / memset", ("memcpy", "memset")),
)


def kernel_category(key: str) -> str:
    """The category of a CUDA kernel, from its name without template and
    parameter lists (whose type names would match other categories)."""
    name = re.split(r"[<(]", key.replace("(anonymous namespace)", ""))[0].lower()
    return next((c for c, keys in _CATEGORIES if any(k.lower() in name for k in keys)),
                "other")


def profile_step(fn, what=f"phase 3c: profile of one bs-{BS} step", top: int = 12):
    """Device time of one call of ``fn`` (a step, a forward) by kernel
    category (torch.profiler), and the device's busy share of its wall
    time, which it returns (None where the profiler saw no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    totals, names, n_kernels = {}, {}, 0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0) or 0
        if (dev_us <= 0 or getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):   # ranges, not kernels
            continue
        cat = kernel_category(evt.key)
        totals[cat] = totals.get(cat, 0.0) + dev_us / 1e3
        names[evt.key] = names.get(evt.key, 0.0) + dev_us / 1e3
        n_kernels += evt.count
    busy = sum(totals.values())
    if busy == 0:
        print(f"{what}: torch.profiler recorded no device time")
        return None
    print(f"{what}: wall {wall_ms:.2f} ms, {n_kernels} kernels, device busy {busy:.2f} ms "
          f"({100 * busy / wall_ms:.1f}% of wall), by category:")
    for cat, ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:44s} {ms:9.3f} ms {100 * ms / busy:5.1f}%")
    print(f"{what}: top kernels:")
    for key, ms in sorted(names.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:9.3f} ms  {key[:110]}")
    return busy / wall_ms


def main():
    import tempfile

    import torch
    t_start = time.perf_counter()

    def ended(what):
        print(f"chip_smoke.py: {what} ended at {time.perf_counter() - t_start:.1f} s")

    card = phase0()
    max_err = phase1()
    fwd_times = time_fwd()
    ended("phase 1 and time_fwd")
    launches = phase2()
    bwd_times, bwd_err = phase3a()
    bwd = bwd_times[SHAPES[0][0], BS, torch.bfloat16]
    phase3b()
    ended("phases 2-3b")
    with tempfile.TemporaryDirectory() as save_dir:
        train_launches, _ = phase3c(card, save_dir)
        ended("phase 3c")
        _, variant_launches = phase4(card)
        ended("phase 4")
        _, inference_launches = phase5(card, save_dir)
        ended("phase 5")
    phase6(card)
    ended("phase 6")
    dp_launches = phase7(card)
    ended("phase 7")
    tp_launches = phase8(card)
    ended("phase 8")
    sp_launches = phase9(card)
    ended("phase 9")
    tpsp_launches, _ = phase10(card)
    ended("phase 10")
    sp_launches_by_phase, _ = sp_phases(card, (phase11_specs, phase12_specs), cut=True)
    sp_transformer_launches, sp_zoo_launches = sp_launches_by_phase[11], sp_launches_by_phase[12]
    ended("phases 11-13")
    from emrt_tpu_torch.ops import deformable_cuda
    name, levels, len_q = SHAPES[0]
    fwd = fwd_times[name, BS, torch.bfloat16]
    plan = deformable_cuda.fwd_plan(levels, HEAD_DIM, torch.bfloat16, BS, HEADS, len_q,
                                    torch.cuda.get_device_properties(0).multi_processor_count)
    timed_at = f"{name} bs {BS} bf16, random locations"

    def at(times, keys):
        """The kernel's numbers at each (name, bs) of ``keys`` (bf16, random
        locations)."""
        return {f"{key} bs {bs} bf16": {
            "ms": times[key, bs, torch.bfloat16]["random"],
            "plain_ms": times[key, bs, torch.bfloat16]["plain"],
            "bound_ms": times[key, bs, torch.bfloat16]["bound"][0],
            "bound_by": times[key, bs, torch.bfloat16]["bound"][1]} for key, bs in keys}

    def at_tp_heads(times):
        """At the TP ranks' head counts (TP_SHAPES, bs 32)."""
        return at(times, [(tp_name, BS) for tp_name, *_ in TP_SHAPES])

    def at_hrnet(times):
        """At the HRNet EMRT's calls (three 32^2 levels, Lq 3,072 and 110):
        8 heads at bs 32 and 8, 4 heads (a tp2 rank's) at bs 32."""
        return at(times, [(name, bs) for name, *_ in SHAPES[5:7] for bs in (BS, TRAIN_BS)]
                  + [(f"{name} nh 4", BS) for name, *_ in SHAPES[5:7]])

    def at_vit768(times):
        """At ViT-L's calls at 768^2 (three 48^2 levels, Lq 6,912 and 110),
        bs 32 and 8."""
        return at(times, [(name, bs) for name, *_ in SHAPES[-2:] for bs in (BS, TRAIN_BS)])

    print(f"chip_smoke.py: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": "ms_deform_attn_fwd", "route": "cuda",
         "source": "emrt_tpu_torch/csrc/ms_deform_attn_fwd.cu",
         "replaces": "emrt_tpu/ops/deformable_pallas.py:50",
         "launches": launches, "launches_train": train_launches[0],
         "launches_variants": variant_launches[0], "launches_inference": inference_launches,
         "launches_dp": dp_launches[0], "launches_tp": tp_launches[0],
         "launches_sp": sp_launches[0], "launches_tpsp": tpsp_launches[0],
         "launches_sp_transformer": sp_transformer_launches[0],
         "launches_sp_zoo": sp_zoo_launches[0],
         "max_abs_err": max_err, "ms": fwd["random"], "ms_on_the_grid": fwd["on the grid"],
         "ms_bs8": fwd_times[name, TRAIN_BS, torch.bfloat16]["random"],
         "plain_ms": fwd["plain"], "bound_ms": fwd["bound"][0], "bound_by": fwd["bound"][1],
         "library_ms": None, "plan": str(plan), "timed_at": timed_at,
         "tp_heads": at_tp_heads(fwd_times), "hrnet": at_hrnet(fwd_times),
         "vit768": at_vit768(fwd_times), "card": card},
        {"name": "ms_deform_attn_bwd", "route": "cuda",
         "source": "emrt_tpu_torch/csrc/ms_deform_attn_bwd.cu",
         "replaces": "emrt_tpu/ops/deformable_pallas.py:200 "
                     "emrt_tpu/ops/deformable_pallas.py:277",
         "launches": train_launches[1], "launches_variants": variant_launches[1],
         "launches_dp": dp_launches[1], "launches_tp": tp_launches[1],
         "launches_sp": sp_launches[1], "launches_tpsp": tpsp_launches[1],
         "launches_sp_transformer": sp_transformer_launches[1],
         "launches_sp_zoo": sp_zoo_launches[1],
         "max_abs_err": bwd_err, "ms": bwd["random"], "ms_on_the_grid": bwd["on the grid"],
         "ms_bs8": bwd_times[SHAPES[0][0], TRAIN_BS, torch.bfloat16]["random"],
         "plain_ms": bwd["plain"], "bound_ms": bwd["bound"][0], "bound_by": bwd["bound"][1],
         "library_ms": None, "timed_at": timed_at, "tp_heads": at_tp_heads(bwd_times),
         "hrnet": at_hrnet(bwd_times), "vit768": at_vit768(bwd_times), "card": card}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main_tp_step():
    """``--tp-step``: phase 0, then phase 8's dp1 x tp2 step alone ((a),
    (b) and (d) over gloo, both ranks on the first card)."""
    import tempfile
    card = phase0()
    with tempfile.TemporaryDirectory() as tmp:
        reference = dp_reference(Path(tmp) / "reference.pt")
        phase8_step(card, "gloo", ["cuda:0"] * TP_WORLD, reference)
    print("chip_smoke.py --tp-step: passed")


def main_sp_step():
    """``--sp-step``: phase 0, then phase 9 without the CLIs ((a), (b) and (d)
    over gloo, both ranks on the first card)."""
    card = phase0()
    phase9(card, torchrun=False)
    print("chip_smoke.py --sp-step: passed")


def main_tpsp_step():
    """``--tpsp-step``: phase 0, then phase 10 without the CLIs ((a), (b), (c)
    and (e) over gloo, the ranks on the first card)."""
    card = phase0()
    phase10(card, torchrun=False)
    print("chip_smoke.py --tpsp-step: passed")


def main_transformer_sp():
    """``--transformer-sp``: phase 0, then phase 11 ((a)-(d) over gloo, the
    ranks on the first card)."""
    card = phase0()
    sp_phases(card, (phase11_specs,))
    print("chip_smoke.py --transformer-sp: passed")


def main_zoo_sp():
    """``--zoo-sp``: phase 0, then phases 12 and 13 at full depth ((a)-(d)
    over gloo, the ranks on the first card)."""
    card = phase0()
    sp_phases(card, (phase12_specs,))
    print("chip_smoke.py --zoo-sp: passed")


def main_norm_seeds():
    """``--norm-seeds``: phase 0, then phase 10 (b) from each seed of
    NORM_SEEDS (the weights, the batch and the dropout masks), every
    reading printed before the checks fail: the spread of the gradient
    norm's gap to one process's beside its rounding control."""
    import tempfile
    card = phase0()
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        for seed in NORM_SEEDS:
            for backbone in SP_BACKBONES:
                failures += phase10_backbone(card, tmp, *backbone, seed=seed, strict=False)[1]
    check(not failures, "; ".join(failures))
    print("chip_smoke.py --norm-seeds: passed")


def main_train_step():
    """``--train-step``: phase 0, then phase 3c's timing of one process's
    bf16 bs-8 train step alone (median of 20)."""
    card = phase0()
    time_train_steps(card, (TRAIN_BS,), reps=20, what="--train-step")


if __name__ == "__main__":
    modes = {"--tp-step": main_tp_step, "--sp-step": main_sp_step,
             "--tpsp-step": main_tpsp_step, "--transformer-sp": main_transformer_sp,
             "--zoo-sp": main_zoo_sp, "--norm-seeds": main_norm_seeds,
             "--train-step": main_train_step}
    if sys.argv[1:] and sys.argv[1] not in modes:
        sys.exit(f"usage: {sys.argv[0]} [{' | '.join(modes)}]")
    modes.get(sys.argv[1] if sys.argv[1:] else None, main)()
