#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``emrt_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0 requires a CUDA device, prints the software versions and the card's
name and power limit, and builds the deformable-attention kernels (K1 the
forward; the backward, one kernel for the TPU's K2 and K3) from
``emrt_tpu_torch/csrc``, one ``nvcc`` per source, all at once, printing
each kernel's registers and spills. Phase 1 holds K1 against its plain
PyTorch version at the flagship call shapes (bs 32; encoder Lq 1,344 and decoder Lq 110 over
levels 32^2, 16^2, 8^2; encoder Lq 5,376 over the 512^2 levels) with three
location sets, checks the wrappers' refusals and that an input requiring
grad goes through the autograd Function, and times both versions.
Phase 2 drives the eval path: the full-width EMRT-R50 of
configs/EMRT/EMRT_256x256_160k_potsdam.yaml in bf16 with seeded random
weights, sliding-window ``evaluate`` (crop 256, stride 171, window batch 32)
over synthetic 1024^2 images, and checks that every model forward launched
K1 six times, that the logits are finite, that mIoU lies in [0, 1] and that
the logits through K1 match those through the plain core.
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
iterations on the ViT and HRNet yamls. Every path checks its kernel launch
counts. Phases 1 and 3a also hold the kernels at the variants' level shapes:
three 16^2 levels (ViT), three 32^2 (HRNet, ResNet OS8) and 32^2/16^2/16^2
(ResNet OS16).

Any failed check raises, and the script then exits non-zero without the
final line. The second-to-last line is a JSON object describing each kernel;
the last line is {"ok": true, "device": {...}}. Nothing here imports JAX.
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
LEVELS_32X3 = ((32, 32),) * 3                      # HRNet, ResNet at output stride 8
LEVELS_OS16 = ((32, 32), (16, 16), (16, 16))       # ResNet at output stride 16
SHAPES = (("encoder 256^2", LEVELS_256, 1344),
          ("decoder 256^2", LEVELS_256, 110),
          ("encoder 512^2", LEVELS_512, 5376),
          ("encoder 16^2x3", LEVELS_VIT, 768),
          ("decoder 16^2x3", LEVELS_VIT, 110),
          ("encoder 32^2x3", LEVELS_32X3, 3072),
          ("decoder 32^2x3", LEVELS_32X3, 110),
          ("encoder 32/16/16", LEVELS_OS16, 1536),
          ("decoder 32/16/16", LEVELS_OS16, 110))
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


def _inputs(levels, len_q, dtype, loc_set, gen, bs=BS):
    import torch
    from emrt_tpu_torch.models.deformable_transformer import _offset_bias_init
    from emrt_tpu_torch.models.position_encoding import encoder_reference_points
    dev = "cuda"
    len_v = sum(h * w for h, w in levels)
    n_lv = len(levels)
    value = torch.randn((bs, len_v, HEADS, HEAD_DIM), generator=gen, device=dev).to(dtype)
    attn = torch.randn((bs, len_q, HEADS, n_lv * POINTS), generator=gen, device=dev)
    attn = attn.softmax(-1).view(bs, len_q, HEADS, n_lv, POINTS).to(dtype)
    shape = (bs, len_q, HEADS, n_lv, POINTS, 2)
    if loc_set == "random":
        loc = torch.rand(shape, generator=gen, device=dev) * 1.2 - 0.1
    elif loc_set == "out of bounds":
        low = torch.rand(shape, generator=gen, device=dev) * 0.4 - 1.0   # [-1.0, -0.6)
        high = torch.rand(shape, generator=gen, device=dev) * 0.4 + 1.6  # [1.6, 2.0)
        loc = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.5, low, high)
    else:   # on the grid: encoder reference points + rotated-grid init offsets
        ref = encoder_reference_points(levels, device=dev)[:len_q]        # [Lq, L, 2]
        off = torch.from_numpy(_offset_bias_init(HEADS, n_lv, POINTS)).to(dev)
        norm = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32, device=dev)
        loc = (ref[:, None, :, None, :]
               + off.view(HEADS, n_lv, POINTS, 2) / norm[None, :, None, :])
        loc = loc.expand(shape).contiguous()
    return value, loc, attn


def _expect_raise(exc, fn, what):
    try:
        fn()
    except exc:
        return
    raise RuntimeError(f"check failed: {what} did not raise {exc.__name__}")


def phase1():
    import torch
    from emrt_tpu_torch.ops import deformable_cuda
    from emrt_tpu_torch.ops.deformable import (deformable_attention,
                                               deformable_attention_core)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, max_err = [], 0.0
    for name, levels, len_q in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for loc_set in ("random", "out of bounds", "on the grid"):
                value, loc, attn = _inputs(levels, len_q, dtype, loc_set, gen)
                out = deformable_cuda.ms_deform_attn_fwd(value, levels, loc, attn)
                ref = deformable_attention_core(value, levels, loc, attn)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                if loc_set == "out of bounds":
                    tol = 0.0
                    check(scale == 0.0, f"{name} plain version not 0 out of bounds")
                elif dtype == torch.float32:
                    tol = 1e-5 * scale + 1e-6
                else:
                    tol = 1e-2 * scale
                check(out.shape == ref.shape and out.dtype == value.dtype,
                      f"{name} output {tuple(out.shape)} {out.dtype}")
                check(bool(torch.isfinite(out).all()), f"{name} non-finite output")
                print(f"phase 1: {name:16s} {str(dtype)[6:]:8s} {loc_set:13s} "
                      f"max|K1-plain| {err:.3e} (tol {tol:.3e}, max|plain| {scale:.3e})")
                check(err <= tol, f"{name} {dtype} {loc_set}: error {err} > {tol}")
                max_err = max(max_err, err)
            value, loc, attn = _inputs(levels, len_q, dtype, "random", gen)
            k_ms = cuda_ms(lambda: deformable_cuda.ms_deform_attn_fwd(value, levels, loc, attn))
            p_ms = cuda_ms(lambda: deformable_attention_core(value, levels, loc, attn))
            # one FMA per channel and valid corner
            k_bound = bound([value, loc, attn, deformable_cuda.ms_deform_attn_fwd(
                value, levels, loc, attn)], 2 * HEAD_DIM * _valid_corners(levels, loc))
            rows.append((name, dtype, k_ms, p_ms, k_bound))
            print(f"phase 1: {name:16s} {str(dtype)[6:]:8s} time K1 {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms (median of 20, CUDA events)")

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
    return rows, max_err


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
    # bs 8 (the yamls' batch): 64 (b, h) on 132 SMs, so the plan splits them
    for name, levels, len_q, bs in [(*shape, BS) for shape in SHAPES] + [
            ("encoder 256^2 bs 8", LEVELS_256, 1344, TRAIN_BS)]:
        plan = deformable_cuda.bwd_plan(levels, HEAD_DIM, bs, HEADS, len_q, n_sms)
        print(f"phase 3a: {name} bs {bs}: plan {plan}")
        for dtype in (torch.float32, torch.bfloat16):
            for loc_set in ("random", "out of bounds", "on the grid"):
                value, loc, attn = _inputs(levels, len_q, dtype, loc_set, gen, bs)
                grad_out = torch.randn((bs, len_q, HEADS * HEAD_DIM), generator=gen,
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
    Returns {(name, bs, dtype): {"random": ms, ...}}."""
    import torch
    from emrt_tpu_torch.ops import deformable_cuda
    from emrt_tpu_torch.ops.deformable import deformable_attention_core
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    ms = functools.partial(cuda_ms, reps=10, warmup=2)
    times = {}
    for bs in (BS, TRAIN_BS):
        for name, levels, len_q in SHAPES:
            other = None
            if other_split and bs * HEADS < n_sms:
                plan = deformable_cuda.bwd_plan(levels, HEAD_DIM, bs, HEADS, len_q, n_sms)
                other = deformable_cuda.bwd_plan(levels, HEAD_DIM, bs, HEADS, len_q, n_sms,
                                                 splits=1 if plan.splits > 1 else 2)
            for dtype in (torch.float32, torch.bfloat16):
                t = {}
                for loc_set in ("on the grid", "random"):
                    value, loc, attn = _inputs(levels, len_q, dtype, loc_set, gen, bs)
                    grad_out = torch.randn((bs, len_q, HEADS * HEAD_DIM), generator=gen,
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


def phase3c(card):
    """The trainer through its entry point; train step times and profile."""
    import tempfile

    import numpy as np
    import torch
    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.models import get_model
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import main as train_main
    from emrt_tpu_torch.train import make_train_step

    with tempfile.TemporaryDirectory() as save_dir:
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
        steps, forwards = first["steps"], first["eval_forwards"]
        print(f"phase 3c: train.main {TRAIN_ITERS} iters at bs {TRAIN_BS} with one save "
              f"and one eval ({forwards} eval forwards) in {train_s:.1f} s; window "
              f"losses {[round(x, 4) for x in first['losses']]}, mIoU {first['mious']}; "
              f"launches forward {launches[0]}, backward {launches[1]}")
        check(steps == TRAIN_ITERS and first["last_iter"] == TRAIN_ITERS,
              f"ran {steps} steps to iter {first['last_iter']}")
        check(len(first["losses"]) > 0 and all(np.isfinite(first["losses"])),
              f"losses {first['losses']}")
        check(len(first["mious"]) == 1 and 0.0 <= first["mious"][0] <= 1.0,
              f"mIoU {first['mious']}")
        check(launches == (6 * (steps + forwards), 6 * steps),
              f"launches {launches} for {steps} steps and {forwards} eval forwards")
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

    # train steps on device batches: host data left out
    cfg = _train_config()
    torch.manual_seed(0)
    model = get_model(cfg, device="cuda")
    schedule = get_scheduler(cfg)
    step = make_train_step(model, get_loss_function(cfg),
                           get_optimizer(cfg, model, schedule))
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for bs in (TRAIN_BS, BS):
        batch = {"image": torch.randn((bs, 3, 256, 256), generator=gen, device="cuda"),
                 "label": torch.randint(0, cfg.DATA.NUM_CLASSES, (bs, 256, 256),
                                        generator=gen, device="cuda")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(batch), reps=10, warmup=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rows[bs] = (ms, bs / ms * 1e3, peak)
        print(f"phase 3c: train step bs {bs} bf16 256^2: {ms:.2f} ms, "
              f"{bs / ms * 1e3:.1f} tiles/s, peak memory {peak:.2f} GiB "
              f"(median of 10, CUDA events; {card})")
    profile_step(lambda: step(batch))
    return launches, rows


VARIANT_YAMLS = ("cswin", "vit", "hrnet", "segformer")   # EMRT_256x256_160k_potsdam_{v}.yaml
# (name, config overrides, the encoder's levels at a 256^2 input)
OTHER_BACKBONES = (("ResNeXt50", {"MODEL.ENCODER.TYPE": "resnext50"}, LEVELS_256),
                   ("ResNeSt50", {"MODEL.ENCODER.TYPE": "resnest50"}, LEVELS_256),
                   ("resnet50c", {"MODEL.ENCODER.TYPE": "resnet50c"}, LEVELS_256),
                   ("resnet50 OS16", {"MODEL.OUTPUT_STRIDE": 16}, LEVELS_OS16),
                   ("resnet50 OS8", {"MODEL.OUTPUT_STRIDE": 8}, LEVELS_32X3))
VARIANT_IMAGES, VARIANT_STEPS = 2, 3


def _variant_config(path, overrides=()):
    from emrt_tpu_torch.config import get_config
    cfg = get_config(str(path))
    cfg.DATA.DATASET = "Synthetic"
    cfg.TRAIN.DTYPE = "bfloat16"
    cfg.merge_from_list([str(v) for kv in overrides for v in kv])
    return cfg


def _train_steps(model, cfg, n, gen):
    """n train steps at TRAIN_BS on device batches; checks each launched the
    forward and the backward kernel six times and that the losses are finite."""
    import numpy as np
    import torch
    from emrt_tpu_torch.losses import get_loss_function
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import make_train_step
    step = make_train_step(model, get_loss_function(cfg),
                           get_optimizer(cfg, model, get_scheduler(cfg)))
    batch = {"image": torch.randn((TRAIN_BS, 3, 256, 256), generator=gen, device="cuda"),
             "label": torch.randint(0, cfg.DATA.NUM_CLASSES, (TRAIN_BS, 256, 256),
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


def phase4_backbone(name, overrides, levels):
    """One full-width bf16 forward and one train step of a CNN backbone."""
    import numpy as np
    import torch
    from emrt_tpu_torch.models import get_model
    cfg = _variant_config(CONFIG, overrides.items())
    torch.manual_seed(0)
    with torch.device("cuda"):
        model = get_model(cfg).eval()
    gen = torch.Generator(device="cuda").manual_seed(5)
    images = torch.randn((TRAIN_BS, 3, 256, 256), generator=gen, device="cuda")
    with torch.inference_mode():
        got = tuple(tuple(m.shape[2:]) for m in model._backbone_features(images[:1])[0])
        check(got == levels, f"{name}: encoder levels {got}, expected {levels}")
        _reset_counts()
        main, aux = model(images)
    launches = _counts()[0]
    check(launches == 6, f"{name}: one forward launched K1 {launches} times")
    check(tuple(main.shape) == (TRAIN_BS, cfg.DATA.NUM_CLASSES, 256, 256)
          and bool(torch.isfinite(main).all() and torch.isfinite(aux).all()),
          f"{name}: logits {tuple(main.shape)} not finite")
    _, _, losses, train_launches = _train_steps(model, cfg, 1, gen)
    print(f"phase 4: {name}: encoder levels {levels}; forward bs {TRAIN_BS} (K1 "
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
    steps, forwards = out["steps"], out["eval_forwards"]
    print(f"phase 4: train.main {iters} iters on {path.name} at bs {TRAIN_BS} in "
          f"{time.perf_counter() - t0:.1f} s: window losses "
          f"{[round(x, 4) for x in out['losses']]}, mIoU {out['mious']}, {forwards} eval "
          f"forwards; launches forward/backward {launches}")
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
    counts += [phase4_trainer(v) for v in ("vit", "hrnet")]
    print(f"phase 4: per variant (bf16 256^2 windows, seeded random weights; {card}):")
    for v, r in rows.items():
        print(f"  {v:10s} evaluate {r['windows_s']:8.1f} windows/s (peak {r['eval_gib']:.2f} "
              f"GiB), train step bs {TRAIN_BS} {r['step_ms']:8.2f} ms (peak "
              f"{r['train_gib']:.2f} GiB)")
    return rows, [sum(c[i] for c in counts) for i in range(2)]


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


def profile_step(fn):
    """Device time of one step by kernel category (torch.profiler), and the
    device's busy share of the step's wall time."""
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
        print("phase 3c: profile: torch.profiler recorded no device time")
        return
    print(f"phase 3c: profile of one bs-{BS} step: wall {wall_ms:.2f} ms, {n_kernels} "
          f"kernels, device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}% of wall), "
          f"by category:")
    for cat, ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:44s} {ms:9.3f} ms {100 * ms / busy:5.1f}%")
    print("phase 3c: top kernels:")
    for key, ms in sorted(names.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:9.3f} ms  {key[:110]}")


def main():
    import torch
    card = phase0()
    rows, max_err = phase1()
    launches = phase2()
    bwd_times, bwd_err = phase3a()
    bwd = bwd_times[SHAPES[0][0], BS, torch.bfloat16]
    phase3b()
    train_launches, _ = phase3c(card)
    _, variant_launches = phase4(card)
    name, _, k_ms, p_ms, (k_bound, k_by) = next(
        r for r in rows if r[0] == "encoder 256^2" and r[1] == torch.bfloat16)
    timed_at = f"{name} bs {BS} bf16, random locations"
    print(json.dumps({"kernels": [
        {"name": "ms_deform_attn_fwd", "route": "cuda",
         "source": "emrt_tpu_torch/csrc/ms_deform_attn_fwd.cu",
         "replaces": "emrt_tpu/ops/deformable_pallas.py:50",
         "launches": launches, "launches_train": train_launches[0],
         "launches_variants": variant_launches[0],
         "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
         "bound_ms": k_bound, "bound_by": k_by, "library_ms": None,
         "timed_at": timed_at, "card": card},
        {"name": "ms_deform_attn_bwd", "route": "cuda",
         "source": "emrt_tpu_torch/csrc/ms_deform_attn_bwd.cu",
         "replaces": "emrt_tpu/ops/deformable_pallas.py:200 "
                     "emrt_tpu/ops/deformable_pallas.py:277",
         "launches": train_launches[1], "launches_variants": variant_launches[1],
         "max_abs_err": bwd_err, "ms": bwd["random"], "ms_on_the_grid": bwd["on the grid"],
         "ms_bs8": bwd_times[SHAPES[0][0], TRAIN_BS, torch.bfloat16]["random"],
         "plain_ms": bwd["plain"], "bound_ms": bwd["bound"][0], "bound_by": bwd["bound"][1],
         "library_ms": None, "timed_at": timed_at, "card": card}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
