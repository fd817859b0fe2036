// Catmull-Rom bicubic sampling of one element of a [K, H, W] float32 image
// stack: the weights, the 16 taps and their sums. The value pass of
// bicubic_rows.cu (K1a), its value-and-derivatives pass (K1b) and the E_g
// element pass of eg_rows.cu all sample through these functions, so the
// three compute the same numbers from the same coordinates.
//
// The function: the coordinates clipped to [1, W-2.001] x [1, H-2.001]
// (fmaxf/fminf: a NaN coordinate samples the clip corner instead of reading
// out of bounds), 16 taps of frame fid weighted by the Catmull-Rom weights,
// the row sums r (and rd with the derivative weights) over a row's taps by
// fmaf, then val, gx and gy over the rows; the derivatives are zeroed where
// the UNCLIPPED x is outside [1, W-2.001) or y outside [1, H-2.001).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace i3d_catrom {

__device__ __forceinline__ void catrom_w(float t, float w[4]) {
  const float t2 = t * t;
  const float t3 = t2 * t;
  w[0] = -0.5f * t + t2 - 0.5f * t3;
  w[1] = 1.0f - 2.5f * t2 + 1.5f * t3;
  w[2] = 0.5f * t + 2.0f * t2 - 1.5f * t3;
  w[3] = -0.5f * t2 + 0.5f * t3;
}

__device__ __forceinline__ void catrom_dw(float t, float w[4]) {
  const float t2 = t * t;
  w[0] = -0.5f + 2.0f * t - 1.5f * t2;
  w[1] = -5.0f * t + 4.5f * t2;
  w[2] = 0.5f + 4.0f * t - 4.5f * t2;
  w[3] = -t + 1.5f * t2;
}

// the upper clip bound of a coordinate over n pixels as float32, the same
// rounding as the Python side
__device__ __forceinline__ float clip_max(int n) { return (float)((double)n - 2.001); }

// the first tap of the 4x4 support of the clipped (xc, yc) in frame fid
__device__ __forceinline__ const float* support(const float* images, int h, int w, uint32_t fid, float x0f,
                                                float y0f) {
  return images + ((int64_t)(int32_t)fid * h + ((int)y0f - 1)) * (int64_t)w + ((int)x0f - 1);
}

// The value alone: the weights, the 16 taps issued together, then the sums
__device__ __forceinline__ float value(const float* images, int h, int w, float xmax, float ymax, uint32_t fid,
                                       float xe, float ye) {
  const float xc = fminf(fmaxf(xe, 1.0f), xmax);
  const float yc = fminf(fmaxf(ye, 1.0f), ymax);
  const float x0f = floorf(xc);
  const float y0f = floorf(yc);
  float wx[4], wy[4];
  catrom_w(xc - x0f, wx);
  catrom_w(yc - y0f, wy);
  const float* tap = support(images, h, w, fid, x0f, y0f);
  float t[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) t[k] = __ldg(tap + (int64_t)(k / 4) * w + (k % 4));
  float val = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float r = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) r = fmaf(wx[i], t[4 * j + i], r);
    val = fmaf(wy[j], r, val);
  }
  return val;
}

// The first pass of the value and derivatives: both axes' weights and
// derivative weights, and the 16 taps issued together
__device__ __forceinline__ void taps(const float* images, int h, int w, float xmax, float ymax, uint32_t fid,
                                     float xe, float ye, float (&t)[16], float (&wx)[4], float (&wy)[4],
                                     float (&dwx)[4], float (&dwy)[4]) {
  const float xc = fminf(fmaxf(xe, 1.0f), xmax);
  const float yc = fminf(fmaxf(ye, 1.0f), ymax);
  const float x0f = floorf(xc);
  const float y0f = floorf(yc);
  catrom_w(xc - x0f, wx);
  catrom_w(yc - y0f, wy);
  catrom_dw(xc - x0f, dwx);
  catrom_dw(yc - y0f, dwy);
  const float* tap = support(images, h, w, fid, x0f, y0f);
#pragma unroll
  for (int k = 0; k < 16; ++k) t[k] = __ldg(tap + (int64_t)(k / 4) * w + (k % 4));
}

// The second pass: val, gx and gy from the taps, then the masks on the
// unclipped coordinates
__device__ __forceinline__ void sums(const float (&t)[16], const float (&wx)[4], const float (&wy)[4],
                                     const float (&dwx)[4], const float (&dwy)[4], float xe, float ye, float xmax,
                                     float ymax, float& val, float& gx, float& gy) {
  val = 0.0f;
  gx = 0.0f;
  gy = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float r = 0.0f, rd = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r = fmaf(wx[i], t[4 * j + i], r);
      rd = fmaf(dwx[i], t[4 * j + i], rd);
    }
    val = fmaf(wy[j], r, val);
    gx = fmaf(wy[j], rd, gx);
    gy = fmaf(dwy[j], r, gy);
  }
  if (!(xe >= 1.0f && xe < xmax)) gx = 0.0f;
  if (!(ye >= 1.0f && ye < ymax)) gy = 0.0f;
}

}  // namespace i3d_catrom
