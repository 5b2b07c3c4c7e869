// Multi-scale deformable attention backward for NVIDIA Hopper (sm_90a).
//
// Two kernels, one for each TPU kernel they replace:
//
//   ms_deform_attn_bwd_value_kernel     <- _bwd_gv_kernel  (kernel K2)
//   ms_deform_attn_bwd_loc_attn_kernel  <- _bwd_gla_kernel (kernel K3)
//
// both in emrt_tpu/ops/deformable_pallas.py. They compute exactly the
// gradients that autograd takes through the plain PyTorch version
// (emrt_tpu_torch/ops/deformable.py), for out = sum_{l,p,corner}
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
// exact zeros in all three gradients.
//
// Layout as the forward: value [bs, Lv, nh, c], loc [bs, Lq, nh, L, P, 2] f32
// (x, y), attn [bs, Lq, nh, L, P], g = grad of out [bs, Lq, nh * c] in value's
// type. One warp takes one (b, q, h) row, lane = channel, in chunks of 32.
//
// K2 (grad value). The TPU kernel builds a dense sampling matrix per query
// tile and contracts it with g on the MXU, carrying gV across the sequential
// grid. Blocks on the GPU run in no order, so here each lane scatters its
// channel's four corner contributions with float atomicAdd into an f32
// [bs, Lv, nh, c] buffer that the wrapper zeroes and then casts to value's
// type. The 32 lanes of a warp add to 32 neighbouring floats, one 128-byte
// line per corner. What bounds it: 4 * L * P atomics per row and channel
// chunk (72 at the flagship's L 3, P 6), contended where neighbouring queries
// share corners; the f32 buffer of a bs-32 flagship call (32 x 1,344 x 256 x
// 4 B, 44 MB) mostly stays in the 50 MB L2. The atomics make the order of
// the f32 sums, and so gV's last bits, differ from run to run; a
// deterministic form (sorted scatter or a gather over inverse indices) is
// left for later.
//
// K3 (grad loc, grad attn). The TPU kernel does the same per query tile with
// dense one-hot products. Here each lane gathers its channel's four corners
// once per sample, as the forward does (the same 4.6 KB of corner reads per
// row at the flagship), forms its share of the three sums, and three
// butterfly shuffles reduce them over the warp; lane 0 writes the row's
// gradients. It reads 70x the bytes it writes, like the forward, and adds
// 15 shuffles per sample.
//
// Sums run in f32. g_loc is stored in f32, g_attn in the attention weights'
// type. No shared-memory staging, TMA or wgmma yet: later, measured changes.

#include "ms_deform_attn_common.cuh"

namespace {

using namespace ms_deform;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Row {
  int64_t row;     // (b * Lq + q) * nh + h
  int lane;
  int head;
  int64_t batch;
};

__device__ __forceinline__ Row this_row(int len_q, int n_heads) {
  Row r;
  r.row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  r.lane = threadIdx.x % 32;
  r.head = static_cast<int>(r.row % n_heads);
  r.batch = r.row / n_heads / len_q;
  return r;
}

template <typename T, typename A>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ms_deform_attn_bwd_value_kernel(const float* __restrict__ loc, const A* __restrict__ attn,
                                const T* __restrict__ grad_out, float* __restrict__ grad_value,
                                int64_t n_rows, int len_q, int len_v, int n_heads,
                                int channels, int n_levels, int n_points, Levels levels) {
  const Row r = this_row(len_q, n_heads);
  if (r.row >= n_rows) return;  // whole warps leave together
  const int n_samples = n_levels * n_points;
  const float* loc_row = loc + r.row * n_samples * 2;
  const A* attn_row = attn + r.row * n_samples;
  const int64_t token_stride = static_cast<int64_t>(n_heads) * channels;
  float* gv_bh = grad_value + r.batch * len_v * token_stride
                 + static_cast<int64_t>(r.head) * channels + r.lane;

  for (int c0 = 0; c0 < channels; c0 += 32) {
    const float g = to_float(grad_out[r.row * channels + c0 + r.lane]);
    float* gv = gv_bh + c0;
    for (int l = 0; l < n_levels; ++l) {
      const int H = levels.h[l];
      const int W = levels.w[l];
      float* gv_l = gv + static_cast<int64_t>(levels.start[l]) * token_stride;
      for (int p = 0; p < n_points; ++p) {
        const int s = l * n_points + p;
        const float ag = to_float(attn_row[s]) * g;
        const Sample sp = sample_at(loc_row[2 * s], loc_row[2 * s + 1], W, H);
        const float ay0 = ag * (1.f - sp.fy);
        const float ay1 = ag * sp.fy;
        if (sp.y0_in) {
          float* row0 = gv_l + static_cast<int64_t>(sp.y0) * W * token_stride;
          if (sp.x0_in) atomicAdd(row0 + sp.x0 * token_stride, ay0 * (1.f - sp.fx));
          if (sp.x1_in) atomicAdd(row0 + (sp.x0 + 1) * token_stride, ay0 * sp.fx);
        }
        if (sp.y1_in) {
          float* row1 = gv_l + static_cast<int64_t>(sp.y0 + 1) * W * token_stride;
          if (sp.x0_in) atomicAdd(row1 + sp.x0 * token_stride, ay1 * (1.f - sp.fx));
          if (sp.x1_in) atomicAdd(row1 + (sp.x0 + 1) * token_stride, ay1 * sp.fx);
        }
      }
    }
  }
}

template <typename T, typename A>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ms_deform_attn_bwd_loc_attn_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                                   const A* __restrict__ attn, const T* __restrict__ grad_out,
                                   float* __restrict__ grad_loc, A* __restrict__ grad_attn,
                                   int64_t n_rows, int len_q, int len_v, int n_heads,
                                   int channels, int n_levels, int n_points, Levels levels) {
  const Row r = this_row(len_q, n_heads);
  if (r.row >= n_rows) return;  // whole warps leave together
  const int n_samples = n_levels * n_points;
  const float* loc_row = loc + r.row * n_samples * 2;
  const A* attn_row = attn + r.row * n_samples;
  const T* g_row = grad_out + r.row * channels + r.lane;
  const int64_t token_stride = static_cast<int64_t>(n_heads) * channels;
  const T* value_bh = value + r.batch * len_v * token_stride
                      + static_cast<int64_t>(r.head) * channels + r.lane;

  for (int l = 0; l < n_levels; ++l) {
    const int H = levels.h[l];
    const int W = levels.w[l];
    const T* v_l = value_bh + static_cast<int64_t>(levels.start[l]) * token_stride;
    for (int p = 0; p < n_points; ++p) {
      const int s = l * n_points + p;
      const Sample sp = sample_at(loc_row[2 * s], loc_row[2 * s + 1], W, H);
      const T* row0 = v_l + static_cast<int64_t>(sp.y0) * W * token_stride;
      const T* row1 = row0 + static_cast<int64_t>(W) * token_stride;
      const int64_t col0 = static_cast<int64_t>(sp.x0) * token_stride;
      const int64_t col1 = col0 + token_stride;
      float g_attn = 0.f, g_x = 0.f, g_y = 0.f;
      for (int c0 = 0; c0 < channels; c0 += 32) {
        const float g = to_float(g_row[c0]);
        const float v00 = sp.y0_in && sp.x0_in ? to_float(row0[col0 + c0]) : 0.f;
        const float v01 = sp.y0_in && sp.x1_in ? to_float(row0[col1 + c0]) : 0.f;
        const float v10 = sp.y1_in && sp.x0_in ? to_float(row1[col0 + c0]) : 0.f;
        const float v11 = sp.y1_in && sp.x1_in ? to_float(row1[col1 + c0]) : 0.f;
        const float top = (1.f - sp.fx) * v00 + sp.fx * v01;
        const float bottom = (1.f - sp.fx) * v10 + sp.fx * v11;
        g_attn += g * ((1.f - sp.fy) * top + sp.fy * bottom);
        g_x += g * ((1.f - sp.fy) * (v01 - v00) + sp.fy * (v11 - v10));
        g_y += g * (bottom - top);
      }
      g_attn = warp_sum(g_attn);
      g_x = warp_sum(g_x);
      g_y = warp_sum(g_y);
      if (r.lane == 0) {
        const float a = to_float(attn_row[s]);
        const int64_t k = r.row * n_samples + s;
        store(grad_attn + k, g_attn);
        grad_loc[2 * k] = a * static_cast<float>(W) * g_x;
        grad_loc[2 * k + 1] = a * static_cast<float>(H) * g_y;
      }
    }
  }
}

// Runs f(T{}, A{}) for the (value, attention) dtype pair of the codes
// 0 = float32, 1 = bfloat16; returns cudaGetLastError() after it, or
// cudaErrorInvalidValue for a pair the kernels do not take.
template <typename F>
int dispatch(int value_dtype, int attn_dtype, F&& f) {
  if (value_dtype == 0 && attn_dtype == 0) {
    f(float{}, float{});
  } else if (value_dtype == 1 && attn_dtype == 0) {
    f(__nv_bfloat16{}, float{});
  } else if (value_dtype == 1 && attn_dtype == 1) {
    f(__nv_bfloat16{}, __nv_bfloat16{});
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

unsigned n_blocks(int64_t n_rows) {
  return static_cast<unsigned>((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// K2. grad_value is an f32 [bs, Lv, nh, c] buffer that the caller has zeroed;
// the kernel adds into it. level_hw is a host array (H0, W0, H1, W1, ...).
extern "C" int ms_deform_attn_bwd_value(const void* loc, const void* attn,
                                        const void* grad_out, void* grad_value,
                                        int value_dtype, int attn_dtype, int batch,
                                        int len_q, int len_v, int n_heads, int channels,
                                        int n_levels, int n_points, const int* level_hw,
                                        void* stream) {
  Levels levels;
  if (channels % 32 != 0 || !make_levels(level_hw, n_levels, len_v, &levels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_rows = static_cast<int64_t>(batch) * len_q * n_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(value_dtype, attn_dtype, [&](auto t, auto a) {
    using T = decltype(t);
    using A = decltype(a);
    ms_deform_attn_bwd_value_kernel<T, A><<<n_blocks(n_rows), kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const float*>(loc), static_cast<const A*>(attn),
        static_cast<const T*>(grad_out), static_cast<float*>(grad_value), n_rows, len_q,
        len_v, n_heads, channels, n_levels, n_points, levels);
  });
}

// K3. grad_loc is f32 [bs, Lq, nh, L, P, 2]; grad_attn [bs, Lq, nh, L, P] in
// the attention weights' type. Every element of both is written.
extern "C" int ms_deform_attn_bwd_loc_attn(const void* value, const void* loc,
                                           const void* attn, const void* grad_out,
                                           void* grad_loc, void* grad_attn, int value_dtype,
                                           int attn_dtype, int batch, int len_q, int len_v,
                                           int n_heads, int channels, int n_levels,
                                           int n_points, const int* level_hw, void* stream) {
  Levels levels;
  if (channels % 32 != 0 || !make_levels(level_hw, n_levels, len_v, &levels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_rows = static_cast<int64_t>(batch) * len_q * n_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(value_dtype, attn_dtype, [&](auto t, auto a) {
    using T = decltype(t);
    using A = decltype(a);
    ms_deform_attn_bwd_loc_attn_kernel<T, A><<<n_blocks(n_rows), kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const T*>(value), static_cast<const float*>(loc),
        static_cast<const A*>(attn), static_cast<const T*>(grad_out),
        static_cast<float*>(grad_loc), static_cast<A*>(grad_attn), n_rows, len_q, len_v,
        n_heads, channels, n_levels, n_points, levels);
  });
}
