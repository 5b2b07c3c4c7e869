#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``emrt_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0 requires a CUDA device, prints the software versions and the card's
name and power limit, and builds the deformable-attention kernels (K1 the
forward, K2 and K3 the backward) from ``emrt_tpu_torch/csrc``, one ``nvcc``
per source, all at once. Phase 1 holds K1 against its plain PyTorch version
at the flagship call shapes (bs 32; encoder Lq 1,344 and decoder Lq 110 over
levels 32^2, 16^2, 8^2; encoder Lq 5,376 over the 512^2 levels) with three
location sets, checks the wrappers' refusals and that an input requiring
grad goes through the autograd Function, and times both versions.
Phase 2 drives the eval path: the full-width EMRT-R50 of
configs/EMRT/EMRT_256x256_160k_potsdam.yaml in bf16 with seeded random
weights, sliding-window ``evaluate`` (crop 256, stride 171, window batch 32)
over synthetic 1024^2 images, and checks that every model forward launched
K1 six times, that the logits are finite, that mIoU lies in [0, 1] and that
the logits through K1 match those through the plain core.
Phase 3 drives the train path. 3a holds K2 and K3 against the plain
version's autograd at phase 1's shapes and location sets and times them;
3b holds the full-width model's loss and parameter gradients (batch 8,
dropout 0; float32 and bf16 with BatchNorm frozen, bf16 with BatchNorm on
batch statistics) through K1-K3 against those through the plain core; 3c runs the
trainer's entry point (``emrt_tpu_torch.train.main``) on the flagship config
with synthetic data at batch 8 with a save and an eval, checks the kernel
launch counts, the finite losses and ``--resume``, then times train steps at
batch 8 and 32 and profiles one batch-32 step by kernel category.

Any failed check raises, and the script then exits non-zero without the
final line. The second-to-last line is a JSON object describing each kernel;
the last line is {"ok": true, "device": {...}}. Nothing here imports JAX.
"""
from __future__ import annotations

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
SHAPES = (("encoder 256^2", LEVELS_256, 1344),
          ("decoder 256^2", LEVELS_256, 110),
          ("encoder 512^2", LEVELS_512, 5376))
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


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


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
    print(f"phase 0: K1, K2, K3 built in {time.perf_counter() - t0:.1f} s")
    for line in deformable_cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    return card


def _inputs(levels, len_q, dtype, loc_set, gen):
    import torch
    from emrt_tpu_torch.models.deformable_transformer import _offset_bias_init
    from emrt_tpu_torch.models.position_encoding import encoder_reference_points
    dev = "cuda"
    len_v = sum(h * w for h, w in levels)
    n_lv = len(levels)
    value = torch.randn((BS, len_v, HEADS, HEAD_DIM), generator=gen, device=dev).to(dtype)
    attn = torch.randn((BS, len_q, HEADS, n_lv * POINTS), generator=gen, device=dev)
    attn = attn.softmax(-1).view(BS, len_q, HEADS, n_lv, POINTS).to(dtype)
    shape = (BS, len_q, HEADS, n_lv, POINTS, 2)
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
                print(f"phase 1: {name:14s} {str(dtype)[6:]:8s} {loc_set:13s} "
                      f"max|K1-plain| {err:.3e} (tol {tol:.3e}, max|plain| {scale:.3e})")
                check(err <= tol, f"{name} {dtype} {loc_set}: error {err} > {tol}")
                max_err = max(max_err, err)
            value, loc, attn = _inputs(levels, len_q, dtype, "random", gen)
            k_ms = cuda_ms(lambda: deformable_cuda.ms_deform_attn_fwd(value, levels, loc, attn))
            p_ms = cuda_ms(lambda: deformable_attention_core(value, levels, loc, attn))
            rows.append((name, dtype, k_ms, p_ms))
            print(f"phase 1: {name:14s} {str(dtype)[6:]:8s} time K1 {k_ms:.4f} ms, "
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


def phase3a():
    """K2 and K3 against the plain version's autograd; their times."""
    import torch
    from emrt_tpu_torch.ops import deformable_cuda
    from emrt_tpu_torch.ops.deformable import deformable_attention_core
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = {"K2": 0.0, "K3": 0.0}
    for name, levels, len_q in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for loc_set in ("random", "out of bounds", "on the grid"):
                value, loc, attn = _inputs(levels, len_q, dtype, loc_set, gen)
                grad_out = torch.randn((BS, len_q, HEADS * HEAD_DIM), generator=gen,
                                       device="cuda").to(dtype)
                got = deformable_cuda.ms_deform_attn_bwd(value, levels, loc, attn, grad_out)
                want = _plain_grads(value, levels, loc, attn, grad_out)
                torch.cuda.synchronize()
                errs = []
                for what, g, w, t in zip(("value", "loc", "attn"), got, want,
                                         (value, loc, attn)):
                    check(g.shape == t.shape and g.dtype == w.dtype == t.dtype,
                          f"{name} grad {what} {tuple(g.shape)} {g.dtype}")
                    check(bool(torch.isfinite(g).all()), f"{name} non-finite grad {what}")
                    err = (g.float() - w.float()).abs().max().item()
                    scale = w.float().abs().max().item()
                    if loc_set == "out of bounds":
                        tol = 0.0
                        check(scale == 0.0, f"{name} plain grad {what} not 0 out of bounds")
                    elif dtype == torch.float32:
                        tol = 1e-5 * scale + 1e-6
                    else:
                        tol = 1e-2 * scale
                    check(err <= tol, f"{name} {dtype} {loc_set} grad {what}: "
                                      f"error {err} > {tol}")
                    kernel = "K2" if what == "value" else "K3"
                    max_err[kernel] = max(max_err[kernel], err)
                    errs.append(f"{what} {err:.2e}/{scale:.2e}")
                print(f"phase 3a: {name:14s} {str(dtype)[6:]:8s} {loc_set:13s} "
                      f"max|kernel-plain| / max|plain|: {', '.join(errs)}")

    # times per call shape and dtype; the JSON line takes the encoder bf16 call
    times = {}
    for name, levels, len_q in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, attn = _inputs(levels, len_q, dtype, "random", gen)
            grad_out = torch.randn((BS, len_q, HEADS * HEAD_DIM), generator=gen,
                                   device="cuda").to(dtype)
            ins = [t.clone().requires_grad_() for t in (value, loc, attn)]
            out = deformable_attention_core(ins[0], levels, ins[1], ins[2])
            args = (value, levels, loc, attn, grad_out)

            def plain(wrt):
                return lambda: torch.autograd.grad(out, [ins[i] for i in wrt], grad_out,
                                                   retain_graph=True)

            # K2's time includes zeroing its f32 buffer and the cast to value's dtype
            t = {"K2": cuda_ms(lambda: deformable_cuda.ms_deform_attn_bwd_value(*args)),
                 "K3": cuda_ms(lambda: deformable_cuda.ms_deform_attn_bwd_loc_attn(*args)),
                 "bwd": cuda_ms(lambda: deformable_cuda.ms_deform_attn_bwd(*args)),
                 "plain K2": cuda_ms(plain((0,))), "plain K3": cuda_ms(plain((1, 2))),
                 "plain bwd": cuda_ms(plain((0, 1, 2)))}
            times[name, dtype] = t
            del out, ins
            print(f"phase 3a: {name:14s} {str(dtype)[6:]:8s} bs {BS} backward (median of "
                  f"20, CUDA events): " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()))
    times = times[SHAPES[0][0], torch.bfloat16]
    return times, max_err


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
    from emrt_tpu_torch.ops import deformable_cuda
    _set_kernel_and_dropout(model, use_kernel=use_kernel)
    model.train(train_bn)
    model.dtype = dtype
    model.zero_grad(set_to_none=True)
    counts = (deformable_cuda.launches, deformable_cuda.bwd_value_launches,
              deformable_cuda.bwd_loc_attn_launches)
    loss = loss_fn(list(model(images)), labels)
    loss.backward()
    torch.cuda.synchronize()
    delta = [c1 - c0 for c0, c1 in zip(counts, (
        deformable_cuda.launches, deformable_cuda.bwd_value_launches,
        deformable_cuda.bwd_loc_attn_launches))]
    check(delta == ([6, 6, 6] if use_kernel else [0, 0, 0]),
          f"use_kernel={use_kernel}: K1/K2/K3 launches {delta}")
    grads = torch.cat([p.grad.flatten() for p in model.parameters()])
    check(bool(torch.isfinite(grads).all()),
          f"non-finite gradients (use_kernel={use_kernel}, {dtype})")
    return loss.item(), grads


def phase3b():
    """The full-width model's loss and gradients through K1-K3 against the
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
    from emrt_tpu_torch.ops import deformable_cuda
    from emrt_tpu_torch.solver import get_optimizer, get_scheduler
    from emrt_tpu_torch.train import main as train_main
    from emrt_tpu_torch.train import make_train_step

    def counts():
        return (deformable_cuda.launches, deformable_cuda.bwd_value_launches,
                deformable_cuda.bwd_loc_attn_launches)

    with tempfile.TemporaryDirectory() as save_dir:
        common = ["--config", str(CONFIG), "--device", "cuda", "--seed", "0",
                  "DATA.DATASET", "Synthetic", "DATA.BATCH_SIZE", str(TRAIN_BS),
                  "TRAIN.DTYPE", "bfloat16", "SAVE_DIR", save_dir,
                  "LOGGING_INFO_FREQ", "5", "SAVE_FREQ_CHECKPOINT", str(TRAIN_ITERS),
                  "VALIDATE_FREQ", str(TRAIN_ITERS)]
        deformable_cuda.launches = deformable_cuda.bwd_value_launches = 0
        deformable_cuda.bwd_loc_attn_launches = 0
        t0 = time.perf_counter()
        first = train_main(["--iters", str(TRAIN_ITERS), *common])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = counts()
        steps, forwards = first["steps"], first["eval_forwards"]
        print(f"phase 3c: train.main {TRAIN_ITERS} iters at bs {TRAIN_BS} with one save "
              f"and one eval ({forwards} eval forwards) in {train_s:.1f} s; window "
              f"losses {[round(x, 4) for x in first['losses']]}, mIoU {first['mious']}; "
              f"launches K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}")
        check(steps == TRAIN_ITERS and first["last_iter"] == TRAIN_ITERS,
              f"ran {steps} steps to iter {first['last_iter']}")
        check(len(first["losses"]) > 0 and all(np.isfinite(first["losses"])),
              f"losses {first['losses']}")
        check(len(first["mious"]) == 1 and 0.0 <= first["mious"][0] <= 1.0,
              f"mIoU {first['mious']}")
        check(launches == (6 * (steps + forwards), 6 * steps, 6 * steps),
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


_CATEGORIES = (   # (category, substrings of a kernel's name), first match wins
    ("K1 deformable fwd", ("ms_deform_attn_fwd",)),
    ("K2 deformable bwd value", ("ms_deform_attn_bwd_value",)),
    ("K3 deformable bwd loc/attn", ("ms_deform_attn_bwd_loc_attn",)),
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
    times, bwd_err = phase3a()
    phase3b()
    train_launches, _ = phase3c(card)
    name, _, k_ms, p_ms = next(r for r in rows if r[0] == "encoder 256^2"
                               and r[1] == torch.bfloat16)
    timed_at = f"{name} bs {BS} bf16"
    source = "emrt_tpu_torch/csrc/ms_deform_attn_bwd.cu"
    print(json.dumps({"kernels": [
        {"name": "ms_deform_attn_fwd", "route": "cuda",
         "source": "emrt_tpu_torch/csrc/ms_deform_attn_fwd.cu",
         "replaces": "emrt_tpu/ops/deformable_pallas.py:50",
         "launches": launches, "launches_train": train_launches[0],
         "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
         "timed_at": timed_at, "card": card},
        {"name": "ms_deform_attn_bwd_value", "route": "cuda", "source": source,
         "replaces": "emrt_tpu/ops/deformable_pallas.py:200",
         "launches": train_launches[1], "max_abs_err": bwd_err["K2"],
         "ms": times["K2"], "plain_ms": times["plain K2"], "timed_at": timed_at,
         "card": card},
        {"name": "ms_deform_attn_bwd_loc_attn", "route": "cuda", "source": source,
         "replaces": "emrt_tpu/ops/deformable_pallas.py:277",
         "launches": train_launches[2], "max_abs_err": bwd_err["K3"],
         "ms": times["K3"], "plain_ms": times["plain K3"], "timed_at": timed_at,
         "card": card}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
