// Multi-scale deformable attention backward for NVIDIA Hopper (sm_90a).
//
// One kernel, ms_deform_attn_bwd_kernel, computes all three gradients in one
// pass. It replaces both TPU backward kernels of
// emrt_tpu/ops/deformable_pallas.py:
//
//   _bwd_gv_kernel  (kernel K2, the value gradient)
//   _bwd_gla_kernel (kernel K3, the location and attention-weight gradients)
//
// It computes exactly the gradients that autograd takes through the plain
// PyTorch version (emrt_tpu_torch/ops/deformable.py), for out = sum_{l,p,corner}
// attn * wx * wy * valid * V[corner] with x = loc_x * W - 0.5, wx = 1 - fx
// for column x0 and fx for column x0 + 1 (likewise in y):
//
//   gV[b, corner, h, c] += attn * wx * wy * valid * g[b, q, h, c]
//   g_attn[b, q, h, l, p] = sum_c g * sample
//   g_loc_x = attn * W * sum_c g * ((1 - fy) * (v01 - v00) + fy * (v11 - v10))
//   g_loc_y = attn * H * sum_c g * ((1 - fx) * (v10 - v00) + fx * (v11 - v01))
//
// where an invalid corner's value counts as 0. d(1 - fx)/dx = -1 and
// dfx/dx = +1 everywhere, integer x included: the one-sided derivative the
// plain version's floor gives (and grid_sample takes). Corners and weights
// come from the same sample_at as the forward, so they are bitwise the plain
// version's, and a location whose four corners are all outside its map gives
// exact zeros in all three gradients. Sums run in f32; g_loc is stored in f32,
// g_attn in the attention weights' type, gV in value's type.
//
// Layout as the forward: value [bs, Lv, nh, c], loc [bs, Lq, nh, L, P, 2] f32
// (x, y), attn [bs, Lq, nh, L, P], g = grad of out [bs, Lq, nh * c] in value's
// type.
//
// Work. A block takes one (b, h) and a tile of its queries: all Lq of them
// unless the wrapper's plan (ops/deformable_cuda.py::bwd_plan) splits a
// (b, h) over several blocks to fill the card. Its units of work are
// (query, level) pairs, level-major, and a group of lanes takes one unit:
// 4 lanes of 8 channels in bf16, 8 lanes of 4 in f32, so that each lane moves
// 16 bytes per corner and a warp works on 8 (bf16) or 4 (f32) samples at
// once. The group loads its slice of the grad_out row once per unit. It
// takes the unit's points in chunks of one per lane: each lane loads its
// point's location (8 bytes) and weight, so the group reads them as one
// contiguous piece, and the group's lanes take each point's by shuffles. Per
// point the group computes the corners once, gathers them, and forms per
// lane the four dot products of g with the corners, from which g_attn, g_x
// and g_y follow. Two (bf16) or three (f32) xor shuffles reduce those over
// the group; the lane that loaded a point keeps its gradients and stores
// them at the chunk's end, again one contiguous piece per group.
//
// gV. The plan puts the f32 gV tile of a level (H * W * c * 4 bytes for the
// block's (b, h)) in shared memory, smallest levels first while they fit the
// 227 KB a block may use: all three at the flagship (168 KB), the 32^2 and
// 16^2 levels at 512^2. The block adds into those tiles with shared-memory
// atomics; at step j a lane adds channel j ^ (its group in the warp), so the
// 32 lanes of a warp hit 32 different banks and never one address. (A float
// atomicAdd on shared memory is a compare-and-swap loop on this card,
// ATOMS.CAST.SPIN; loops written by hand with atomicCAS, batched or 64 bits
// wide, ran several times slower on the H100.) A level
// left out (64^2 at 512^2) adds with 16-byte float4 global atomics (red: the
// result is unused) into an f32 buffer gv_acc [bs, Lv, nh, c]. When one block
// owns every query of its (b, h) (the plan's write mode), the buffer's rows of
// that (b, h) are the block's own: it zeroes them first, and at the end it
// writes every level of gV once, in value's type, from its tiles and those
// rows. No zero-fill, no cast and no atomics between blocks. When the plan
// splits a (b, h) (accumulate mode), the wrapper zeroes gv_acc, blocks add
// their tiles into it with float4 atomics, and the wrapper casts it. Either
// way the adds land in the order the warps run, so gV's last bits may differ
// from run to run; g_loc and g_attn do not.
//
// What bounds it. Each input byte read once and each output byte written once
// make 189.8 MB at the flagship encoder call (bs 32, bf16), 56.7 us at
// 3.35 TB/s. The gathers read 18 samples x 4 corners x 64 B = 4.6 KB per
// (b, q, h) row (1.59 GB per call), from L2 and, since a block reads only its
// (b, h)'s 86 KB slice of value, partly from L1. The shared-memory adds take
// the place of K2's 24.8 M warp-wide global reductions; each is a
// compare-and-swap loop that waits on shared memory twice, and with one
// block per SM too few warps hide that. The gathers and those adds bound the
// kernel together, far above the bytes' bound.

#include "ms_deform_attn_common.cuh"

namespace {

using namespace ms_deform;

// One block per SM where the tiles take most of its shared memory, so the
// block brings all the warps it can: 32 of the SM's 64, at most 64 registers
// each (ptxas spills a little; 768 or 512 threads without spills ran slower).
constexpr int kThreads = 1024;

// The wrapper's launch plan, as the C entry receives it.
struct Plan {
  int q_tile;                 // queries of one (b, h) per block
  int accumulate;             // 1: blocks share a (b, h); add everything into gv_acc
  int smem_bytes;             // dynamic shared memory: the tiles of the levels in it
  int smem_off[kMaxLevels];   // a level's f32 gV tile in shared memory (floats); -1: global
};

// A lane's slice of a grad_out row in f32 (g), and the same with its entries
// permuted as gs[j] = g[j ^ r] with static register indices.
template <typename T, int N>
__device__ __forceinline__ void load_g(const T* p, int r, float (&g)[N], float (&gs)[N]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  if constexpr (N == 4) {
    g[0] = __uint_as_float(raw.x); g[1] = __uint_as_float(raw.y);
    g[2] = __uint_as_float(raw.z); g[3] = __uint_as_float(raw.w);
  } else {
    g[0] = bf16_lo(raw.x); g[1] = bf16_hi(raw.x); g[2] = bf16_lo(raw.y); g[3] = bf16_hi(raw.y);
    g[4] = bf16_lo(raw.z); g[5] = bf16_hi(raw.z); g[6] = bf16_lo(raw.w); g[7] = bf16_hi(raw.w);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) gs[j] = g[j];
#pragma unroll
  for (int bit = N / 2; bit > 0; bit >>= 1) {
    if (r & bit) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (!(j & bit)) {
          const float t = gs[j];
          gs[j] = gs[j | bit];
          gs[j | bit] = t;
        }
      }
    }
  }
}

template <typename T, typename A, bool kOneChunk>
__global__ void __launch_bounds__(kThreads, 1)
ms_deform_attn_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                          const A* __restrict__ attn, const T* __restrict__ grad_out,
                          T* __restrict__ grad_value, float* __restrict__ gv_acc,
                          float* __restrict__ grad_loc, A* __restrict__ grad_attn,
                          int len_q, int len_v, int n_heads, int channels, int n_levels,
                          int n_points, Levels levels, Plan plan) {
  constexpr int kV = kVec<T>;       // channels per lane
  constexpr int kLanes = 32 / kV;   // lanes per sample
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);

  const int tiles = (len_q + plan.q_tile - 1) / plan.q_tile;
  const int bh = blockIdx.x / tiles;
  const int q_begin = (blockIdx.x % tiles) * plan.q_tile;
  const int n_q = min(plan.q_tile, len_q - q_begin);
  const int h = bh % n_heads;
  const int64_t b = bh / n_heads;
  const int64_t token_stride = static_cast<int64_t>(n_heads) * channels;
  const int64_t bh_off = b * len_v * token_stride + static_cast<int64_t>(h) * channels;
  const int c4 = channels / 4;   // float4s per token
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // zero the tiles and, in write mode, this block's rows of gv_acc
  for (int i = threadIdx.x; i < plan.smem_bytes / 16; i += kThreads) smem[i] = zero4;
  if (!plan.accumulate) {
    for (int l = 0; l < n_levels; ++l) {
      if (plan.smem_off[l] >= 0) continue;
      const int n = levels.h[l] * levels.w[l] * c4;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        store4(gv_acc + bh_off + (levels.start[l] + i / c4) * token_stride + (i % c4) * 4, zero4);
      }
    }
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int sub = lane % kLanes;   // lane within the group
  const int grp = lane / kLanes;   // group within the warp, < kV
  const unsigned mask = ((1u << kLanes) - 1u) << (grp * kLanes);
  const int n_units = n_levels * n_q;
  for (int u = threadIdx.x / kLanes; u < n_units; u += kThreads / kLanes) {
    const int l = u / n_q;
    const int64_t row = (b * len_q + q_begin + u % n_q) * n_heads + h;
    const int H = levels.h[l];
    const int W = levels.w[l];
    const int off = plan.smem_off[l];
    const int r = off >= 0 ? grp : 0;   // the bank swizzle of the shared adds
    const int64_t sample0 = (row * n_levels + l) * n_points;   // index of (row, l, 0)
    const float2* loc_u = reinterpret_cast<const float2*>(loc) + sample0;
    const A* attn_u = attn + sample0;
    const int64_t level_off = bh_off + static_cast<int64_t>(levels.start[l]) * token_stride
                              + sub * kV;
    const T* v_l = value + level_off;
    float* acc_l = gv_acc + level_off;             // used by a global level only
    float* tile_l = tile + off + sub * kV;         // used by a shared level only
    const T* g_row = grad_out + row * channels + sub * kV;
    float g[kV], gs[kV];
    if constexpr (kOneChunk) load_g(g_row, r, g, gs);

    // points in chunks of kLanes: lane sub loads point p0 + sub's location
    // and weight, every lane of the group takes each point's by a shuffle,
    // and lane sub keeps and stores point p0 + sub's gradients
    for (int p0 = 0; p0 < n_points; p0 += kLanes) {
      const int mine = p0 + sub;
      const bool has = mine < n_points;
      const float2 my_xy = has ? __ldg(loc_u + mine) : make_float2(0.f, 0.f);
      const float my_a = has ? to_float(attn_u[mine]) : 0.f;
      float out_attn = 0.f, out_x = 0.f, out_y = 0.f;
      const int n = min(kLanes, n_points - p0);
      for (int i = 0; i < n; ++i) {
        const int src = grp * kLanes + i;
        const float a = __shfl_sync(mask, my_a, src);
        const Sample sp = sample_at(__shfl_sync(mask, my_xy.x, src),
                                    __shfl_sync(mask, my_xy.y, src), W, H);
        const float wx0 = 1.f - sp.fx;
        const float wy0 = 1.f - sp.fy;
        const float ay0 = a * wy0;
        const float ay1 = a * sp.fy;
        // corners (x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)
        const bool ok[4] = {sp.y0_in && sp.x0_in, sp.y0_in && sp.x1_in,
                            sp.y1_in && sp.x0_in, sp.y1_in && sp.x1_in};
        const int t00 = sp.y0 * W + sp.x0;   // a corner's token is read only if it is valid
        const int tok[4] = {t00, t00 + 1, t00 + W, t00 + W + 1};
        const float w[4] = {ay0 * wx0, ay0 * sp.fx, ay1 * wx0, ay1 * sp.fx};
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c0 = 0; c0 < (kOneChunk ? 32 : channels); c0 += 32) {
          if constexpr (!kOneChunk) load_g(g_row + c0, r, g, gs);
          uint4 v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[k] = ok[k] ? __ldg(reinterpret_cast<const uint4*>(v_l + tok[k] * token_stride + c0))
                         : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) d[k] += dot16(v[k], g);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (!ok[k]) continue;
            if (off >= 0) {
              float* t = tile_l + tok[k] * channels + c0;
#pragma unroll
              for (int j = 0; j < kV; ++j) atomicAdd(t + (j ^ r), w[k] * gs[j]);
            } else {   // r == 0 here: gs is g in order
              float4* t = reinterpret_cast<float4*>(acc_l + tok[k] * token_stride + c0);
#pragma unroll
              for (int j = 0; j < kV / 4; ++j) {
                atomicAdd(t + j, make_float4(w[k] * gs[4 * j], w[k] * gs[4 * j + 1],
                                             w[k] * gs[4 * j + 2], w[k] * gs[4 * j + 3]));
              }
            }
          }
        }
        float s_attn = wy0 * (wx0 * d[0] + sp.fx * d[1]) + sp.fy * (wx0 * d[2] + sp.fx * d[3]);
        float s_x = wy0 * (d[1] - d[0]) + sp.fy * (d[3] - d[2]);
        float s_y = wx0 * (d[2] - d[0]) + sp.fx * (d[3] - d[1]);
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1) {
          s_attn += __shfl_xor_sync(mask, s_attn, o);
          s_x += __shfl_xor_sync(mask, s_x, o);
          s_y += __shfl_xor_sync(mask, s_y, o);
        }
        if (sub == i) {
          out_attn = s_attn;
          out_x = a * static_cast<float>(W) * s_x;
          out_y = a * static_cast<float>(H) * s_y;
        }
      }
      if (has) {
        store(grad_attn + sample0 + mine, out_attn);
        reinterpret_cast<float2*>(grad_loc)[sample0 + mine] = make_float2(out_x, out_y);
      }
    }
  }
  __syncthreads();

  // gV out: write mode stores every level once in value's type; accumulate
  // mode adds the shared tiles into gv_acc (the global levels are there already)
  for (int l = 0; l < n_levels; ++l) {
    const int off = plan.smem_off[l];
    if (plan.accumulate && off < 0) continue;
    const int n = levels.h[l] * levels.w[l] * c4;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int t = i / c4;
      const int c = (i % c4) * 4;
      const int64_t gi = bh_off + (levels.start[l] + t) * token_stride + c;
      const float4 s = off >= 0 ? smem[(off + t * channels + c) / 4]
                                : __ldcg(reinterpret_cast<const float4*>(gv_acc + gi));
      if (plan.accumulate) {
        atomicAdd(reinterpret_cast<float4*>(gv_acc + gi), s);
      } else {
        store4(grad_value + gi, s);
      }
    }
  }
}

template <typename T, typename A, bool kOneChunk>
int launch(const void* value, const void* loc, const void* attn, const void* grad_out,
           void* grad_value, void* gv_acc, void* grad_loc, void* grad_attn, int batch,
           int len_q, int len_v, int n_heads, int channels, int n_levels, int n_points,
           const Levels& levels, const Plan& plan, cudaStream_t stream) {
  auto kernel = ms_deform_attn_bwd_kernel<T, A, kOneChunk>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(batch) * n_heads
                          * ((len_q + plan.q_tile - 1) / plan.q_tile);
  kernel<<<blocks, kThreads, plan.smem_bytes, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc), static_cast<const A*>(attn),
      static_cast<const T*>(grad_out), static_cast<T*>(grad_value), static_cast<float*>(gv_acc),
      static_cast<float*>(grad_loc), static_cast<A*>(grad_attn), len_q, len_v, n_heads,
      channels, n_levels, n_points, levels, plan);
  return static_cast<int>(cudaGetLastError());
}

// The plan from its ints (q_tile, accumulate, smem_bytes, one offset per
// level); false if it does not fit the levels and buffers it is given.
bool make_plan(const int* ints, const Levels& levels, int n_levels, int channels,
               bool have_acc, bool have_out, Plan* plan) {
  *plan = Plan{ints[0], ints[1], ints[2], {-1, -1, -1, -1}};
  if (plan->q_tile < 1 || plan->smem_bytes < 0 || plan->smem_bytes % 16) return false;
  bool global = false;
  for (int l = 0; l < n_levels; ++l) {
    const int off = ints[3 + l];
    const int64_t floats = static_cast<int64_t>(levels.h[l]) * levels.w[l] * channels;
    if (off >= 0 && (off % 4 || (off + floats) * 4 > plan->smem_bytes)) return false;
    plan->smem_off[l] = off;
    global = global || off < 0;
  }
  return (have_acc || !(global || plan->accumulate)) && (have_out || plan->accumulate);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. level_hw is a host array
// (H0, W0, H1, W1, ...), plan_ints the wrapper's plan (see make_plan).
// grad_value [bs, Lv, nh, c] in value's type is written in write mode;
// gv_acc, an f32 buffer of the same shape, is needed when a level is global
// or in accumulate mode, where the caller has zeroed it and gV is left in it.
// grad_loc f32 [bs, Lq, nh, L, P, 2] and grad_attn [bs, Lq, nh, L, P] in the
// attention weights' type are written in full. Returns the error of
// cudaFuncSetAttribute or cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int ms_deform_attn_bwd(const void* value, const void* loc, const void* attn,
                                  const void* grad_out, void* grad_value, void* gv_acc,
                                  void* grad_loc, void* grad_attn, int value_dtype,
                                  int attn_dtype, int batch, int len_q, int len_v, int n_heads,
                                  int channels, int n_levels, int n_points, const int* level_hw,
                                  const int* plan_ints, void* stream) {
  Levels levels;
  Plan plan;
  if (channels % 32 != 0 || !make_levels(level_hw, n_levels, len_v, &levels)
      || !make_plan(plan_ints, levels, n_levels, channels, gv_acc != nullptr,
                    grad_value != nullptr, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto by_shape = [&](auto t, auto a) {
    using T = decltype(t);
    using A = decltype(a);
    auto go = channels == 32 ? launch<T, A, true> : launch<T, A, false>;
    return go(value, loc, attn, grad_out, grad_value, gv_acc, grad_loc, grad_attn, batch,
              len_q, len_v, n_heads, channels, n_levels, n_points, levels, plan, s);
  };
  if (value_dtype == 0 && attn_dtype == 0) return by_shape(float{}, float{});
  if (value_dtype == 1 && attn_dtype == 0) return by_shape(__nv_bfloat16{}, float{});
  if (value_dtype == 1 && attn_dtype == 1) return by_shape(__nv_bfloat16{}, __nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}
