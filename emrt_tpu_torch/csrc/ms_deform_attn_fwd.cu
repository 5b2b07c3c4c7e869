// Multi-scale deformable attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel emrt_tpu/ops/deformable_pallas.py::_fused_fwd_kernel
// (kernel K1 of ROADMAP.md queue 2). It computes what that kernel computes,
//
//   out[b, q, h*c + ch] = sum_l sum_p attn[b, q, h, l, p]
//                         * bilinear(V_l[b, :, h, ch], loc[b, q, h, l, p]),
//
// with x = loc_x * W_l - 0.5, y = loc_y * H_l - 0.5 and zero padding, but not
// in the TPU's form. The TPU builds a dense sampling matrix per query tile and
// contracts it with V on its MXU. Here a (b, q, h) row reads 18 samples x 4
// corners = 72 of 1,344 tokens at the flagship, so that matrix would be 95%
// zeros (1,344 / 72 = 19x the work) and wgmma has nothing dense to contract:
// the kernel gathers the four corners directly, on the CUDA cores.
//
// Layout. value [bs, Lv, nh, c] (levels flattened level-major), loc
// [bs, Lq, nh, L, P, 2] f32 in (x, y) order, attn [bs, Lq, nh, L, P], out
// [bs, Lq, nh * c] in value's type.
//
// What bounds it on this card. Each input byte read once and each output byte
// written once make 105.9 MB at the flagship encoder call (bs 32, Lq 1,344,
// bf16): 31.6 us at 3.35 TB/s. What the kernel really moves is more: the
// gathers read 18 x 4 corners x 64 B = 4.6 KB per row, 1.59 GB per call, and
// each sample costs the same coordinate arithmetic whatever its width. So
// the gathers' source (L2 or shared memory) and the instructions per sample
// set its time, not HBM. The design answers each:
//
// - Instructions. A group of lanes takes one (b, q, h) row and 32 of its
//   channels: 4 lanes of 8 channels in bf16, 8 lanes of 4 in f32, so a lane
//   moves 16 bytes per corner and a warp works on 8 (bf16) or 4 (f32) rows
//   at once.
//   A warp instruction of the coordinate arithmetic (sample_at, shared with
//   the backward) thus serves 8 or 4 rows, where a warp per row spent one on
//   each row. Each lane reads each valid corner as one 16-byte load and
//   accumulates its channels in f32 registers. The group loads a chunk of
//   the row's points (8-byte location, weight) as one contiguous piece, one
//   point per lane, and hands each point to the group by __shfl_sync. Each
//   lane stores its 16 bytes of out once: plain stores, no atomics, no
//   cross-lane sum. A head dim of 64 or more is a row's 32-channel chunks
//   taken as separate units of work.
// - Gather source. A block takes one (b, h) and a tile of its queries
//   (blockIdx = (b, h) x tile, as the launch plan says), so all its corners
//   come from one (b, h) value slab: Lv tokens x c channels, strided by nh * c
//   in value. The block copies the slab's levels that the plan stages into
//   shared memory with 16-byte cp.async.cg copies (L2 only, one commit group
//   per level), waits once, and reads those levels' corners with LDS.128 at
//   32-bit shared addresses (a generic pointer cost a conversion per load);
//   the other levels (64^2 at 512^2) are read from global memory through
//   __ldg.
//   The flagship slab is 86 KB in bf16 (two blocks an SM) and 172 KB in f32
//   (one). A split (b, h) re-reads its slab from L2 per block: no atomics.
// - Banks. In bf16 a token is 64 B, half the 32 banks, and an LDS.128 quarter-
//   warp phase holds two groups: they conflict only when they read different
//   tokens of the same parity. The groups of a warp take neighbouring queries,
//   whose corners on the pixel grid are the same or neighbouring tokens, so
//   the plain [token][channel] layout keeps them apart; an xor swizzle by a
//   token bit would make some neighbouring pairs collide instead, and random
//   locations conflict half the time under any layout. In f32 a token is
//   128 B and a phase one group: no conflicts.
//
// Numerics. The corners and weights come from sample_at, bitwise the plain
// PyTorch version's. Sums run in f32 in the order (level, point, corner
// (x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)); an invalid corner
// is read as zero, which adds an exact zero, so the sums are those of a
// kernel that skips it. A location with all four corners outside its map
// gives exact zeros.

#include <mutex>

#include "ms_deform_attn_common.cuh"

namespace {

using namespace ms_deform;

// Two blocks an SM where their slabs fit side by side (at most 64 registers
// a thread); one block otherwise.
constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;   // the dynamic shared memory a block may use

// The wrapper's launch plan, as the C entry receives it.
struct Plan {
  int q_tile;                 // queries of one (b, h) per block
  int smem_bytes;             // dynamic shared memory: the staged levels of the slab
  int smem_off[kMaxLevels];   // a level's [token][c] slab in shared memory (bytes); -1: global
};

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A 16-byte load from shared memory at a 32-bit shared address (no generic
// address to convert per load); zeros where !ok.
__device__ __forceinline__ uint4 lds16(unsigned addr, bool ok) {
  uint4 v;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %5, 0;\n"
      " mov.b32 %0, 0;\n mov.b32 %1, 0;\n mov.b32 %2, 0;\n mov.b32 %3, 0;\n"
      " @p ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n}"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "r"(addr), "r"(static_cast<int>(ok)));
  return v;
}

// One level's samples of a row into acc: the group's lanes take the points in
// chunks of kLanes (lane sub loads point p0 + sub) and each point by shuffles.
// kShared: the corners come from the staged slab (slab: the shared address of
// the level's first token at this lane's channels), else from value (v_l,
// likewise).
template <bool kShared, typename T, typename A, int kV>
__device__ __forceinline__ void gather_level(float (&acc)[kV], const float2* loc_u,
                                             const A* attn_u, int n_points, int W, int H,
                                             unsigned slab, int token_bytes, const T* v_l,
                                             int64_t token_stride, int sub, int grp,
                                             unsigned mask) {
  constexpr int kLanes = 32 / kV;
  for (int p0 = 0; p0 < n_points; p0 += kLanes) {
    const int mine = p0 + sub;
    const bool has = mine < n_points;
    const float2 my_xy = has ? __ldg(loc_u + mine) : make_float2(0.f, 0.f);
    const float my_a = has ? to_float(attn_u[mine]) : 0.f;
    const int n = min(kLanes, n_points - p0);
    for (int i = 0; i < n; ++i) {
      const int src = grp * kLanes + i;
      const float a = __shfl_sync(mask, my_a, src);
      const Sample sp = sample_at(__shfl_sync(mask, my_xy.x, src),
                                  __shfl_sync(mask, my_xy.y, src), W, H);
      const float ay0 = a * (1.f - sp.fy);
      const float ay1 = a * sp.fy;
      // corners (x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)
      const bool ok[4] = {sp.y0_in && sp.x0_in, sp.y0_in && sp.x1_in,
                          sp.y1_in && sp.x0_in, sp.y1_in && sp.x1_in};
      const int t00 = sp.y0 * W + sp.x0;   // a corner's token is read only if it is valid
      const int tok[4] = {t00, t00 + 1, t00 + W, t00 + W + 1};
      const float w[4] = {ay0 * (1.f - sp.fx), ay0 * sp.fx, ay1 * (1.f - sp.fx), ay1 * sp.fx};
      // one corner at a time: the compiler schedules the loads ahead as the
      // 64 registers allow (loading all four first spills at 64 registers)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint4 v;
        if constexpr (kShared) {
          v = lds16(slab + tok[k] * token_bytes, ok[k]);
        } else {   // a level's tokens times nh * c stay below 2^31 (the wrapper checks)
          v = ok[k] ? __ldg(reinterpret_cast<const uint4*>(
                            v_l + tok[k] * static_cast<int>(token_stride)))
                    : make_uint4(0u, 0u, 0u, 0u);
        }
        axpy16(acc, w[k], v);
      }
    }
  }
}

template <typename T, typename A>
__global__ void __launch_bounds__(kThreads, 2)
ms_deform_attn_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                          const A* __restrict__ attn, T* __restrict__ out, int len_q,
                          int len_v, int n_heads, int channels, int n_levels, int n_points,
                          Levels levels, Plan plan) {
  constexpr int kV = kVec<T>;       // channels per lane
  constexpr int kLanes = 32 / kV;   // lanes per row
  extern __shared__ uint4 slab[];

  const int tiles = (len_q + plan.q_tile - 1) / plan.q_tile;
  const int bh = blockIdx.x / tiles;
  const int q_begin = (blockIdx.x % tiles) * plan.q_tile;
  const int n_q = min(plan.q_tile, len_q - q_begin);
  const int h = bh % n_heads;
  const int64_t b = bh / n_heads;
  const int64_t token_stride = static_cast<int64_t>(n_heads) * channels;
  const T* value_bh = value + b * len_v * token_stride + static_cast<int64_t>(h) * channels;
  const int token16 = channels / kV;   // 16-byte pieces of a token
  const unsigned slab_base = static_cast<unsigned>(__cvta_generic_to_shared(slab));

  // stage the plan's levels of this (b, h)'s slab, one commit group each
  for (int l = 0; l < n_levels; ++l) {
    const int off = plan.smem_off[l];
    if (off < 0) continue;
    const T* src = value_bh + static_cast<int64_t>(levels.start[l]) * token_stride;
    const unsigned dst = slab_base + off;
    const int n = levels.h[l] * levels.w[l] * token16;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int t = i / token16;
      cp_async16(dst + 16u * i, src + t * token_stride + (i - t * token16) * kV);
    }
    cp_async_commit();
  }
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int sub = lane % kLanes;   // lane within the group
  const int grp = lane / kLanes;   // group within the warp
  const unsigned mask = ((1u << kLanes) - 1u) << (grp * kLanes);
  const int n_chunks = channels / 32;
  const int n_units = n_q * n_chunks;   // (query, 32-channel chunk) pairs
  for (int u = threadIdx.x / kLanes; u < n_units; u += kThreads / kLanes) {
    const int64_t row = (b * len_q + q_begin + u / n_chunks) * n_heads + h;
    const int c = (u % n_chunks) * 32 + sub * kV;   // this lane's first channel
    float acc[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) acc[j] = 0.f;
    for (int l = 0; l < n_levels; ++l) {
      const int64_t sample0 = (row * n_levels + l) * n_points;   // index of (row, l, 0)
      const float2* loc_u = reinterpret_cast<const float2*>(loc) + sample0;
      const A* attn_u = attn + sample0;
      const int off = plan.smem_off[l];
      if (off >= 0) {
        gather_level<true, T>(acc, loc_u, attn_u, n_points, levels.w[l], levels.h[l],
                              slab_base + off + c * static_cast<int>(sizeof(T)), token16 * 16,
                              nullptr,
                              token_stride, sub, grp, mask);
      } else {
        gather_level<false, T>(acc, loc_u, attn_u, n_points, levels.w[l], levels.h[l],
                               0u, 0,
                               value_bh + static_cast<int64_t>(levels.start[l]) * token_stride + c,
                               token_stride, sub, grp, mask);
      }
    }
    store16(out + row * channels + c, acc);
  }
}

// Lets the kernel's blocks take up to kMaxSmem of dynamic shared memory, once
// per device and instantiation: the limit serves every plan, and setting it on
// every launch cost host time at calls that are mostly host time.
template <typename T, typename A>
cudaError_t allow_max_smem() {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(ms_deform_attn_fwd_kernel<T, A>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, typename A>
int launch(const void* value, const void* loc, const void* attn, void* out, int batch,
           int len_q, int len_v, int n_heads, int channels, int n_levels, int n_points,
           const Levels& levels, const Plan& plan, cudaStream_t stream) {
  auto kernel = ms_deform_attn_fwd_kernel<T, A>;
  const cudaError_t err = allow_max_smem<T, A>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(batch) * n_heads
                          * ((len_q + plan.q_tile - 1) / plan.q_tile);
  kernel<<<blocks, kThreads, plan.smem_bytes, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc), static_cast<const A*>(attn),
      static_cast<T*>(out), len_q, len_v, n_heads, channels, n_levels, n_points, levels, plan);
  return static_cast<int>(cudaGetLastError());
}

// The plan from its ints (q_tile, smem_bytes, one byte offset per level);
// false if its staged levels do not fit its shared memory side by side.
bool make_plan(const int* ints, const Levels& levels, int n_levels, int token_bytes,
               Plan* plan) {
  *plan = Plan{ints[0], ints[1], {-1, -1, -1, -1}};
  if (plan->q_tile < 1 || plan->smem_bytes < 0 || plan->smem_bytes > kMaxSmem
      || plan->smem_bytes % 16) {
    return false;
  }
  int64_t end[kMaxLevels];
  for (int l = 0; l < n_levels; ++l) {
    const int off = ints[2 + l];
    end[l] = off + static_cast<int64_t>(levels.h[l]) * levels.w[l] * token_bytes;
    if (off >= 0 && (off % 16 || end[l] > plan->smem_bytes)) return false;
    for (int k = 0; k < l && off >= 0; ++k) {
      if (plan->smem_off[k] >= 0 && off < end[k] && plan->smem_off[k] < end[l]) return false;
    }
    plan->smem_off[l] = off < 0 ? -1 : off;
  }
  return true;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. level_hw is a host array
// (H0, W0, H1, W1, ...), plan_ints the wrapper's plan (see make_plan).
// Returns the error of allow_max_smem or cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int ms_deform_attn_fwd(const void* value, const void* loc, const void* attn,
                                  void* out, int value_dtype, int attn_dtype, int batch,
                                  int len_q, int len_v, int n_heads, int channels,
                                  int n_levels, int n_points, const int* level_hw,
                                  const int* plan_ints, void* stream) {
  Levels levels;
  Plan plan;
  const int token_bytes = channels * (value_dtype == 0 ? 4 : 2);
  if (channels % 32 != 0 || !make_levels(level_hw, n_levels, len_v, &levels)
      || !make_plan(plan_ints, levels, n_levels, token_bytes, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto t, auto a) {
    return launch<decltype(t), decltype(a)>(value, loc, attn, out, batch, len_q, len_v,
                                            n_heads, channels, n_levels, n_points, levels,
                                            plan, s);
  };
  if (value_dtype == 0 && attn_dtype == 0) return go(float{}, float{});
  if (value_dtype == 1 && attn_dtype == 0) return go(__nv_bfloat16{}, float{});
  if (value_dtype == 1 && attn_dtype == 1) return go(__nv_bfloat16{}, __nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}
