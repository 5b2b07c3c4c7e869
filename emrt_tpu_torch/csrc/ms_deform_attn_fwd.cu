// Multi-scale deformable attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel emrt_tpu/ops/deformable_pallas.py::_fused_fwd_kernel
// (kernel K1 of ROADMAP.md queue 2). It computes what that kernel computes,
//
//   out[b, q, h*c + ch] = sum_l sum_p attn[b, q, h, l, p]
//                         * bilinear(V_l[b, :, h, ch], loc[b, q, h, l, p]),
//
// with x = loc_x * W_l - 0.5, y = loc_y * H_l - 0.5 and zero padding, but not
// in the TPU's form (a dense sampling matrix per query tile contracted on the
// MXU). On the GPU it is a direct four-corner gather.
//
// Layout. value [bs, Lv, nh, c] (levels flattened level-major),
// loc [bs, Lq, nh, L, P, 2] f32 in (x, y) order, attn [bs, Lq, nh, L, P],
// out [bs, Lq, nh * c]. One warp computes one (b, q, h) row, lane = channel,
// in chunks of 32 channels. The row's L * P locations and weights are the
// same for every lane (one broadcast load each), so every branch below is
// warp-uniform. The corners are floor-based, each with its own validity mask,
// as in the jnp golden (emrt_tpu/ops/deformable.py). Sums run in f32; the
// result is stored in value's type.
//
// What bounds it. Gathered bytes: each (b, q, h) row reads L*P*4 corner
// vectors of c values. At the flagship shape (L 3, P 6, c 32, bf16) that is
// 18 samples x 4 corners x 64 B = 4.6 KB per row against 64 B of output,
// about 70x the output's bytes. Lanes read neighbouring channels, so each
// corner read is one 64 B (bf16) or 128 B (f32) transaction. The whole value
// slab of a flagship call (bs 32 x 1,344 tokens x 256 channels x 2 B, about
// 22 MB) fits in the H100's 50 MB L2, so the scattered corner reads mostly
// hit L2 rather than HBM. The coordinate arithmetic uses round-to-nearest
// intrinsics (no FMA contraction), so the corners and weights are bitwise the
// plain PyTorch version's; only the order of the f32 sum differs.
//
// This first version stages nothing in shared memory and issues no TMA or
// wgmma: those are for later, measured changes.

#include "ms_deform_attn_common.cuh"

namespace {

using namespace ms_deform;

template <typename T, typename A>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ms_deform_attn_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                          const A* __restrict__ attn, T* __restrict__ out,
                          int64_t n_rows, int len_q, int len_v, int n_heads,
                          int channels, int n_levels, int n_points, Levels levels) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= n_rows) return;  // whole warps leave together
  const int lane = threadIdx.x % 32;
  const int head = static_cast<int>(row % n_heads);
  const int64_t batch = row / n_heads / len_q;
  const int n_samples = n_levels * n_points;
  const float* loc_row = loc + row * n_samples * 2;
  const A* attn_row = attn + row * n_samples;
  const int64_t token_stride = static_cast<int64_t>(n_heads) * channels;
  const T* value_bh = value + batch * len_v * token_stride
                      + static_cast<int64_t>(head) * channels + lane;

  for (int c0 = 0; c0 < channels; c0 += 32) {
    const T* v = value_bh + c0;
    float acc = 0.f;
    for (int l = 0; l < n_levels; ++l) {
      const int H = levels.h[l];
      const int W = levels.w[l];
      const T* v_l = v + static_cast<int64_t>(levels.start[l]) * token_stride;
      for (int p = 0; p < n_points; ++p) {
        const int s = l * n_points + p;
        const float a = to_float(attn_row[s]);
        const Sample sp = sample_at(loc_row[2 * s], loc_row[2 * s + 1], W, H);
        const float fx = sp.fx;
        const float fy = sp.fy;
        const int x0 = sp.x0;
        const int y0 = sp.y0;
        const bool x0_in = sp.x0_in, x1_in = sp.x1_in;
        const bool y0_in = sp.y0_in, y1_in = sp.y1_in;
        const float ay0 = a * (1.f - fy);
        const float ay1 = a * fy;
        if (y0_in) {
          const T* r = v_l + static_cast<int64_t>(y0) * W * token_stride;
          if (x0_in) acc += ay0 * (1.f - fx) * to_float(r[x0 * token_stride]);
          if (x1_in) acc += ay0 * fx * to_float(r[(x0 + 1) * token_stride]);
        }
        if (y1_in) {
          const T* r = v_l + static_cast<int64_t>(y0 + 1) * W * token_stride;
          if (x0_in) acc += ay1 * (1.f - fx) * to_float(r[x0 * token_stride]);
          if (x1_in) acc += ay1 * fx * to_float(r[(x0 + 1) * token_stride]);
        }
      }
    }
    store(out + row * channels + c0 + lane, acc);
  }
}

template <typename T, typename A>
void launch(const void* value, const void* loc, const void* attn, void* out,
            int64_t n_rows, int len_q, int len_v, int n_heads, int channels,
            int n_levels, int n_points, const Levels& levels, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  ms_deform_attn_fwd_kernel<T, A><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const A*>(attn), static_cast<T*>(out), n_rows, len_q, len_v,
      n_heads, channels, n_levels, n_points, levels);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. level_hw is a host array
// (H0, W0, H1, W1, ...). Returns cudaGetLastError() after the launch.
extern "C" int ms_deform_attn_fwd(const void* value, const void* loc, const void* attn,
                                  void* out, int value_dtype, int attn_dtype, int batch,
                                  int len_q, int len_v, int n_heads, int channels,
                                  int n_levels, int n_points, const int* level_hw,
                                  void* stream) {
  Levels levels;
  if (channels % 32 != 0 || !make_levels(level_hw, n_levels, len_v, &levels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_rows = static_cast<int64_t>(batch) * len_q * n_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == 0 && attn_dtype == 0) {
    launch<float, float>(value, loc, attn, out, n_rows, len_q, len_v, n_heads, channels,
                         n_levels, n_points, levels, s);
  } else if (value_dtype == 1 && attn_dtype == 0) {
    launch<__nv_bfloat16, float>(value, loc, attn, out, n_rows, len_q, len_v, n_heads,
                                 channels, n_levels, n_points, levels, s);
  } else if (value_dtype == 1 && attn_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(value, loc, attn, out, n_rows, len_q, len_v,
                                         n_heads, channels, n_levels, n_points, levels, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
