// Pieces shared by the deformable-attention kernels (ms_deform_attn_fwd.cu,
// ms_deform_attn_bwd.cu): the level table, the value-type conversions, the
// 16-byte lane helpers and the bilinear sample position of one (x, y)
// location.
//
// The sample position is computed exactly as the plain PyTorch version
// (emrt_tpu_torch/ops/deformable.py) computes it: x = loc_x * W - 0.5 with
// round-to-nearest intrinsics (no FMA contraction), floor-based corners and a
// validity flag per corner row and column, tested in float so that far-off
// coordinates never reach an int cast. So corners and bilinear weights are
// bitwise the plain version's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace ms_deform {

constexpr int kMaxLevels = 4;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];  // first token of each level in value's Lv axis
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Channels of value a lane holds: 16 bytes of them (4 f32 or 8 bf16).
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// sum_j g[j] * v[j] over the 16 bytes v holds (4 f32 or 8 bf16)
__device__ __forceinline__ float dot16(const uint4& v, const float (&g)[4]) {
  return g[0] * __uint_as_float(v.x) + g[1] * __uint_as_float(v.y)
         + g[2] * __uint_as_float(v.z) + g[3] * __uint_as_float(v.w);
}
__device__ __forceinline__ float dot16(const uint4& v, const float (&g)[8]) {
  return g[0] * bf16_lo(v.x) + g[1] * bf16_hi(v.x) + g[2] * bf16_lo(v.y)
         + g[3] * bf16_hi(v.y) + g[4] * bf16_lo(v.z) + g[5] * bf16_hi(v.z)
         + g[6] * bf16_lo(v.w) + g[7] * bf16_hi(v.w);
}

// acc[j] += w * v[j] over the 16 bytes v holds, one f32 FMA per channel
__device__ __forceinline__ void axpy16(float (&acc)[4], float w, const uint4& v) {
  acc[0] += w * __uint_as_float(v.x);
  acc[1] += w * __uint_as_float(v.y);
  acc[2] += w * __uint_as_float(v.z);
  acc[3] += w * __uint_as_float(v.w);
}
__device__ __forceinline__ void axpy16(float (&acc)[8], float w, const uint4& v) {
  acc[0] += w * bf16_lo(v.x);
  acc[1] += w * bf16_hi(v.x);
  acc[2] += w * bf16_lo(v.y);
  acc[3] += w * bf16_hi(v.y);
  acc[4] += w * bf16_lo(v.z);
  acc[5] += w * bf16_hi(v.z);
  acc[6] += w * bf16_lo(v.w);
  acc[7] += w * bf16_hi(v.w);
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  unsigned u;
  memcpy(&u, &v, 4);
  return u;
}

// four f32 values stored in p's type (16 or 8 bytes)
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

// a lane's 16 bytes of output from its f32 sums
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  store4(p, make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                            pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

// Where one normalised location samples a W x H map: corner (x0, y0), the
// fractions fx, fy, and whether column x0 / x0 + 1 and row y0 / y0 + 1 lie
// inside the map.
struct Sample {
  int x0, y0;
  float fx, fy;
  bool x0_in, x1_in, y0_in, y1_in;
};

__device__ __forceinline__ Sample sample_at(float loc_x, float loc_y, int W, int H) {
  const float x = __fsub_rn(__fmul_rn(loc_x, static_cast<float>(W)), 0.5f);
  const float y = __fsub_rn(__fmul_rn(loc_y, static_cast<float>(H)), 0.5f);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  Sample s;
  s.fx = x - x0f;
  s.fy = y - y0f;
  s.x0_in = x0f >= 0.f && x0f < W;
  s.x1_in = x0f + 1.f >= 0.f && x0f + 1.f < W;
  s.y0_in = y0f >= 0.f && y0f < H;
  s.y1_in = y0f + 1.f >= 0.f && y0f + 1.f < H;
  s.x0 = static_cast<int>(x0f);
  s.y0 = static_cast<int>(y0f);
  return s;
}

// Level table from a host array (H0, W0, H1, W1, ...); false if the levels
// are out of range or do not add up to len_v.
inline bool make_levels(const int* level_hw, int n_levels, int len_v, Levels* levels) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  *levels = Levels{};
  int start = 0;
  for (int l = 0; l < n_levels; ++l) {
    levels->h[l] = level_hw[2 * l];
    levels->w[l] = level_hw[2 * l + 1];
    levels->start[l] = start;
    start += levels->h[l] * levels->w[l];
  }
  return start == len_v;
}

}  // namespace ms_deform
