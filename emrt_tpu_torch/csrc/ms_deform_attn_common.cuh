// Pieces shared by the deformable-attention kernels (ms_deform_attn_fwd.cu,
// ms_deform_attn_bwd.cu): the level table, the value-type conversions and the
// bilinear sample position of one (x, y) location.
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

namespace ms_deform {

constexpr int kMaxLevels = 4;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];  // first token of each level in value's Lv axis
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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
