"""Wrappers of the Hopper kernels for multi-scale deformable attention.

Two kernels stand for the three TPU kernels of ROADMAP.md queue 2:

- K1, the forward: ``ms_deform_attn_fwd`` (``csrc/ms_deform_attn_fwd.cu``),
  launched as ``fwd_plan`` says;
- K2 and K3, the gradients of value, of the locations and of the attention
  weights, in one fused pass: ``ms_deform_attn_bwd``
  (``csrc/ms_deform_attn_bwd.cu``), launched as ``bwd_plan`` says.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``emrt_tpu_torch/_build/`` at first use (all
sources at once, one ``nvcc`` each), rebuilt whenever the hash of the
``csrc/`` files changes, and loaded with ``ctypes``. A missing ``nvcc`` or a
failed build raises: there is no fallback. Nothing here touches CUDA or the
compiler at import time.

Each wrapper checks its arguments, allocates its outputs, launches on
PyTorch's current stream and raises if the launch was refused. Each launch
adds one to the kernel's counter: ``launches`` (K1), ``bwd_launches`` (the
backward).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = {"ms_deform_attn_fwd": CSRC / "ms_deform_attn_fwd.cu",
           "ms_deform_attn_bwd": CSRC / "ms_deform_attn_bwd.cu"}
HEADERS = (CSRC / "ms_deform_attn_common.cuh",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_LEVELS = 4
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# C entry -> (library, argtypes); every entry ends with
# (..., int n_levels, int n_points, const int* level_hw, const int* plan,
# void* stream)
_SHAPE_ARGS = [_INT] * 9 + [ctypes.POINTER(_INT), ctypes.POINTER(_INT), _PTR]
_ENTRIES = {
    "ms_deform_attn_fwd": ("ms_deform_attn_fwd", [_PTR] * 4 + _SHAPE_ARGS),
    "ms_deform_attn_bwd": ("ms_deform_attn_bwd", [_PTR] * 8 + _SHAPE_ARGS),
}
# shared memory one block may use on the H100 (227 KB), and its SM count
SMEM_PER_BLOCK, H100_SMS = 232_448, 132
# an SM's shared memory (228 KB) and what the card reserves of it per block
SMEM_PER_SM, SMEM_RESERVED = 233_472, 1_024
# K1's blocks an SM: at most 2 (512 threads of at most 64 registers each),
# fewer where their staged levels do not fit side by side
FWD_MAX_BLOCKS_PER_SM = 2
# K1 splits a (b, h) into at most ceil(Lq / FWD_SPLIT_QUERIES) blocks, so a
# tile may hold a little under 64 queries: the decoder's 110 at bs 8 go to 2
# blocks of 55, faster on the H100 by K1's device time than 1 block of 110
# or 3 of 37 at every yaml's level shapes
FWD_SPLIT_QUERIES = 64
# least queries per block where K1 always stages the slab (on the H100, by
# K1's device time: the encoder calls, 192 and more a block, faster staged at
# 39 of 40 points); shorter blocks (the 110-query decoder calls) stage only
# where the staged blocks fit the card in one wave: where staging left one
# block an SM, 256 such blocks ran faster reading L2 at 8 of 8 points
FWD_MIN_STAGE_QUERIES = 128
# least queries per block where a (b, h) is split: on the H100 at bs 8 the
# split in 2 won at 384 and more queries a block (every encoder call) and
# lost or tied at 55 (the decoder's 110)
BWD_MIN_QUERIES = 256

launches = 0        # K1 launches since the last reset by the caller
bwd_launches = 0    # backward launches
build_log = ""      # nvcc/ptxas output of the builds this process made
_fns: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the deformable-attention kernels cannot be built")
    return path


def build() -> dict:
    """Compile what is missing (one ``nvcc`` per source, all started
    together), load the libraries and return {entry name: C function}."""
    global build_log
    if _fns:
        return _fns
    shared = b"".join(h.read_bytes() for h in HEADERS) + " ".join(NVCC_FLAGS).encode()
    libs, procs = {}, {}
    for name, source in SOURCES.items():
        digest = hashlib.sha256(source.read_bytes() + shared).hexdigest()[:16]
        libs[name] = BUILD_DIR / f"{name}-{digest}.so"
        if not libs[name].exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = libs[name].with_name(f"{libs[name].name}.{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log += f"--- {SOURCES[name].name}\n{out}"
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name].name} (exit {proc.returncode})")
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError(f"nvcc failed to build {', '.join(failed)}:\n{build_log}")
    fns = {}
    for entry, (lib, argtypes) in _ENTRIES.items():
        fn = getattr(ctypes.CDLL(str(libs[lib])), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[entry] = fn
    _fns.update(fns)
    return _fns


def _check_args(value, spatial_shapes, sampling_locations, attention_weights):
    """Raise on anything the kernel does not take (device aside)."""
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    if sampling_locations.dtype != torch.float32:
        raise TypeError(f"sampling_locations must be float32, got "
                        f"{sampling_locations.dtype}")
    if attention_weights.dtype not in (torch.float32, value.dtype):
        raise TypeError(f"attention_weights must be float32 or {value.dtype}, "
                        f"got {attention_weights.dtype}")
    if value.dim() != 4:
        raise ValueError(f"value must be [bs, Lv, nh, c], got {tuple(value.shape)}")
    bs, len_v, n_heads, channels = value.shape
    if sampling_locations.dim() != 6 or sampling_locations.shape[-1] != 2:
        raise ValueError(f"sampling_locations must be [bs, Lq, nh, L, P, 2], "
                         f"got {tuple(sampling_locations.shape)}")
    _, len_q, _, n_levels, n_points, _ = sampling_locations.shape
    if tuple(sampling_locations.shape[:3]) != (bs, len_q, n_heads):
        raise ValueError(f"sampling_locations {tuple(sampling_locations.shape)} "
                         f"does not match value {tuple(value.shape)}")
    if tuple(attention_weights.shape) != (bs, len_q, n_heads, n_levels, n_points):
        raise ValueError(f"attention_weights {tuple(attention_weights.shape)} "
                         f"does not match sampling_locations "
                         f"{tuple(sampling_locations.shape)}")
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"the kernel takes 1 to {MAX_LEVELS} levels, got {n_levels}")
    if len(spatial_shapes) != n_levels:
        raise ValueError(f"{n_levels} sampling levels but {len(spatial_shapes)} "
                         f"spatial shapes")
    if sum(h * w for h, w in spatial_shapes) != len_v:
        raise ValueError(f"spatial shapes {tuple(spatial_shapes)} do not sum "
                         f"to Lv = {len_v}")
    if max(h * w for h, w in spatial_shapes) * n_heads * channels >= 2 ** 31:
        raise ValueError(f"a level's tokens x heads x head dim must stay below 2^31 "
                         f"(32-bit offsets), got levels {tuple(spatial_shapes)}")
    if channels % 32:
        raise ValueError(f"head dim must be a multiple of 32 (the kernels take "
                         f"32-channel chunks), got {channels}")
    for name, t in (("value", value), ("sampling_locations", sampling_locations),
                    ("attention_weights", attention_weights)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_device(*tensors):
    if any(t.device.type != "cuda" or t.device != tensors[0].device for t in tensors):
        raise ValueError(f"the kernel takes tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")


def _launch(entry, pointers, value, spatial_shapes, sampling_locations,
            attention_weights, plan_ints):
    """Call the C entry with the tensors' pointers (None for a null one), the
    shared shape arguments, the plan's ints and PyTorch's current stream;
    raise if it reports an error."""
    fn = build()[entry]
    bs, len_v, n_heads, channels = value.shape
    _, len_q, _, n_levels, n_points, _ = sampling_locations.shape
    level_hw = (ctypes.c_int * (2 * n_levels))(
        *[int(d) for hw in spatial_shapes for d in hw])
    with torch.cuda.device(value.device):
        err = fn(*[None if t is None else t.data_ptr() for t in pointers],
                 _DTYPE_CODE[value.dtype], _DTYPE_CODE[attention_weights.dtype],
                 bs, len_q, len_v, n_heads, channels, n_levels, n_points,
                 level_hw, (ctypes.c_int * len(plan_ints))(*plan_ints),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def _check_alignment(**tensors):
    """The kernels' wide loads: 16 bytes of value (and grad_out), 8 of a
    location."""
    for name, t in tensors.items():
        align = 8 if name == "sampling_locations" else 16
        if t.data_ptr() % align:
            raise ValueError(f"{name} must start at a multiple of {align} bytes")


def _check_plan(plan, spatial_shapes):
    if plan is not None and len(plan.smem_offsets) != len(spatial_shapes):
        raise ValueError(f"the plan has {len(plan.smem_offsets)} levels, the call "
                         f"{len(spatial_shapes)}")


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _pack_levels(sizes):
    """Byte offsets of the levels (sizes in bytes) placed side by side in
    shared memory, smallest first while they fit ``SMEM_PER_BLOCK``, -1 for
    the rest; and the bytes used."""
    offsets, used = [-1] * len(sizes), 0
    for lvl in sorted(range(len(sizes)), key=sizes.__getitem__):
        if used + sizes[lvl] <= SMEM_PER_BLOCK:
            offsets[lvl], used = used, used + sizes[lvl]
    return offsets, used


@dataclass(frozen=True)
class FwdPlan:
    """How ``ms_deform_attn_fwd`` launches (``csrc/ms_deform_attn_fwd.cu``):
    one block per (b, h) and tile of ``q_tile`` queries, ``splits`` tiles per
    (b, h); per level, the byte offset of its [token][c] value slab in the
    block's ``smem_bytes`` of shared memory, or -1 where its corners are read
    from global memory; ``blocks_per_sm`` blocks fit an SM."""
    q_tile: int
    splits: int
    smem_offsets: tuple
    smem_bytes: int
    blocks_per_sm: int

    @property
    def staged(self) -> int:
        """How many levels are staged in shared memory."""
        return sum(off >= 0 for off in self.smem_offsets)

    def ints(self):
        """(q_tile, smem_bytes, offset per level) for the C entry."""
        return (self.q_tile, self.smem_bytes, *self.smem_offsets)


@functools.lru_cache(maxsize=None)   # one plan per call shape: a lookup per launch
def fwd_plan(spatial_shapes, channels, dtype, batch, n_heads, len_q, n_sms=H100_SMS,
             splits=None, q_tile=None, stage=None) -> FwdPlan:
    """K1's launch plan, from the level shapes (a tuple of (H, W) tuples),
    the head dim and value's dtype (the slab's size), and, for the split,
    the batch, heads, queries and SMs.

    Levels go to shared memory smallest first while their slabs fit
    ``SMEM_PER_BLOCK``; two blocks share an SM where their slabs fit side by
    side, else one. Unless ``splits`` or ``q_tile`` is given, a (b, h) is
    split over as many blocks as the card holds at once beside the others'
    (the floor of its blocks over the (b, h)), and over 2 at least where a
    level does not fit and is read from global memory; never over more than
    ceil(Lq / ``FWD_SPLIT_QUERIES``). A split costs no atomics, only a
    re-read of the slab from L2. Unless ``stage`` is given, the slab is
    staged where a block takes ``FWD_MIN_STAGE_QUERIES`` queries or more,
    and for shorter blocks only where, staged, they all fit the card at
    once: a second wave of short blocks costs more than the copy saves.

    On the H100, by K1's device time at the yamls' bs 8 and at bs 32: one
    block more than the floor (5 in bf16, 3 in f32 at bs 8) was 15-40%
    slower at every encoder call; at bs 32 two blocks a (b, h) against one
    were 4-20% faster at the calls with a level in global memory (512^2,
    and three 32^2 levels in f32) and from 3% faster to 4% slower where
    every level is staged.
    """
    def per_sm(used):
        return min(FWD_MAX_BLOCKS_PER_SM, SMEM_PER_SM // (used + SMEM_RESERVED))

    sizes = [h * w * channels * dtype.itemsize for h, w in spatial_shapes]
    offsets, used = _pack_levels(sizes)
    if q_tile is None:
        if splits is None:   # as many blocks as fit the card with the slab staged
            splits = n_sms * per_sm(used) // max(1, batch * n_heads)
            if min(offsets) < 0:   # a level in global memory
                splits = max(splits, 2)
            splits = max(1, min(splits, -(-len_q // FWD_SPLIT_QUERIES)))
        q_tile = -(-len_q // splits)
    if stage is None:
        blocks = batch * n_heads * -(-len_q // q_tile)
        stage = q_tile >= FWD_MIN_STAGE_QUERIES or blocks <= n_sms * per_sm(used)
    if not stage:
        offsets, used = [-1] * len(sizes), 0
    return FwdPlan(q_tile, -(-len_q // q_tile), tuple(offsets), used, per_sm(used))


def ms_deform_attn_fwd(value, spatial_shapes, sampling_locations,
                       attention_weights, plan=None):
    """Kernel K1: same contract as ``ops.deformable.deformable_attention_core``.

    value [bs, Lv, nh, c] (f32 or bf16); sampling_locations
    [bs, Lq, nh, L, P, 2] f32; attention_weights [bs, Lq, nh, L, P] (f32 or
    value's dtype) -> [bs, Lq, nh*c] in value's dtype, f32 accumulation.
    ``plan`` defaults to ``fwd_plan``'s for these shapes on this card.
    """
    global launches
    _check_plan(plan, spatial_shapes)
    _check_args(value, spatial_shapes, sampling_locations, attention_weights)
    _check_alignment(value=value, sampling_locations=sampling_locations)
    _check_device(value, sampling_locations, attention_weights)
    bs, _, n_heads, channels = value.shape
    len_q = sampling_locations.shape[1]
    out = torch.empty((bs, len_q, n_heads * channels), dtype=value.dtype,
                      device=value.device)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = fwd_plan(tuple(map(tuple, spatial_shapes)), channels, value.dtype, bs,
                        n_heads, len_q, _sm_count(value.device.index))
    _launch("ms_deform_attn_fwd",
            (value, sampling_locations, attention_weights, out),
            value, spatial_shapes, sampling_locations, attention_weights, plan.ints())
    launches += 1
    return out


def _check_bwd_args(value, spatial_shapes, sampling_locations, attention_weights,
                    grad_out):
    """The forward's checks, plus grad_out's shape, dtype and contiguity, and
    the alignment of the backward's wide loads (16 bytes of value and
    grad_out, 8 of a location)."""
    _check_args(value, spatial_shapes, sampling_locations, attention_weights)
    bs, _, n_heads, channels = value.shape
    want = (bs, sampling_locations.shape[1], n_heads * channels)
    if tuple(grad_out.shape) != want:
        raise ValueError(f"grad_out must be {want}, got {tuple(grad_out.shape)}")
    if grad_out.dtype != value.dtype:
        raise TypeError(f"grad_out must be {value.dtype} (the output's dtype), "
                        f"got {grad_out.dtype}")
    if not grad_out.is_contiguous():
        raise ValueError("grad_out must be contiguous")
    _check_alignment(value=value, grad_out=grad_out, sampling_locations=sampling_locations)
    _check_device(value, sampling_locations, attention_weights, grad_out)


@dataclass(frozen=True)
class BwdPlan:
    """How ``ms_deform_attn_bwd`` launches (``csrc/ms_deform_attn_bwd.cu``):
    one block per (b, h) and tile of ``q_tile`` queries, ``splits`` tiles per
    (b, h); per level, the offset in floats of its f32 gV tile in the
    block's ``smem_bytes`` of shared memory, or -1 where the level adds to
    global memory."""
    q_tile: int
    splits: int
    smem_offsets: tuple
    smem_bytes: int

    @property
    def accumulate(self) -> bool:
        """Blocks share a (b, h): gV is summed in a zeroed f32 buffer."""
        return self.splits > 1

    @property
    def needs_buffer(self) -> bool:
        """Whether the kernel needs the f32 buffer (a global level, or
        accumulate mode)."""
        return self.accumulate or min(self.smem_offsets) < 0

    def ints(self):
        """(q_tile, accumulate, smem_bytes, offset per level) for the C entry."""
        return (self.q_tile, int(self.accumulate), self.smem_bytes, *self.smem_offsets)


@functools.lru_cache(maxsize=None)   # one plan per call shape: a lookup per launch
def bwd_plan(spatial_shapes, channels, batch, n_heads, len_q,
             n_sms=H100_SMS, splits=None) -> BwdPlan:
    """The backward's launch plan, from the level shapes and the head dim
    (and, for the split, the batch, heads, queries and SMs); the level
    shapes as a tuple of (H, W) tuples. The tiles are f32 whatever value's
    dtype, so the plan does not depend on it.

    Levels go to shared memory smallest first while their f32 tiles fit
    ``SMEM_PER_BLOCK``: the coarse levels, whose corners neighbouring queries
    share most, come first. Unless ``splits`` is given, a (b, h) is split
    over blocks only while there are fewer (b, h) than SMs, and never below
    ``BWD_MIN_QUERIES`` queries a block, since each split block adds its
    whole tile to global memory.
    """
    offsets, used = _pack_levels([h * w * channels * 4 for h, w in spatial_shapes])
    if splits is None:
        splits = max(1, min(n_sms // max(1, batch * n_heads),
                            -(-len_q // BWD_MIN_QUERIES)))
    q_tile = -(-len_q // splits)
    return BwdPlan(q_tile, -(-len_q // q_tile), tuple(o // 4 for o in offsets), used)


def ms_deform_attn_bwd(value, spatial_shapes, sampling_locations,
                       attention_weights, grad_out, plan=None):
    """Kernels K2 and K3, fused: the gradients of ``ms_deform_attn_fwd`` at
    ``grad_out`` ([bs, Lq, nh*c], value's dtype), exactly those of the plain
    version's autograd: (grad_value in value's dtype, grad_sampling_locations
    f32, grad_attention_weights in the attention weights' dtype), each in
    the shape of its input.

    gV is summed in f32 with shared-memory (and, for levels that do not fit,
    global) atomics, so its last bits depend on the order the card ran them
    in; see ``bwd_plan`` for when an f32 buffer is zeroed and cast. ``plan``
    defaults to ``bwd_plan``'s for these shapes on this card.
    """
    global bwd_launches
    _check_plan(plan, spatial_shapes)
    _check_bwd_args(value, spatial_shapes, sampling_locations, attention_weights,
                    grad_out)
    if grad_out.numel() == 0:
        return (torch.zeros_like(value), torch.zeros_like(sampling_locations),
                torch.zeros_like(attention_weights))
    bs, _, n_heads, channels = value.shape
    if plan is None:
        plan = bwd_plan(tuple(map(tuple, spatial_shapes)), channels, bs, n_heads,
                        grad_out.shape[1], _sm_count(value.device.index))
    grad_loc = torch.empty_like(sampling_locations)
    grad_attn = torch.empty_like(attention_weights)
    grad_value = None if plan.accumulate else torch.empty_like(value)
    acc = None
    if plan.needs_buffer:
        make = torch.zeros if plan.accumulate else torch.empty
        acc = make(value.shape, dtype=torch.float32, device=value.device)
    _launch("ms_deform_attn_bwd",
            (value, sampling_locations, attention_weights, grad_out, grad_value, acc,
             grad_loc, grad_attn),
            value, spatial_shapes, sampling_locations, attention_weights, plan.ints())
    bwd_launches += 1
    if plan.accumulate:
        grad_value = acc.to(value.dtype)
    return grad_value, grad_loc, grad_attn
