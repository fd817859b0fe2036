// Masked Catmull-Rom bicubic sampling of a [K, H, W] float32 image stack at
// per-element (fid, x, y), in three modes: the value (VALUE); the value and
// the two directional derivatives d/dx and d/dy (VALUE_GRAD); and, given a
// per-element cotangent g, g*d/dx and g*d/dy without the value (BACKWARD).
//
// Replaces the Pallas TPU kernels of intrinsic3d_tpu/ops/pallas/bicubic.py:
//   _win_fwd_kernel     (called from _call_fwd,     the primal of bicubic_sample_rows)
//   _win_fwdgrad_kernel (called from _call_fwdgrad, its vjp forward rule _rows_fwd_rule)
//   _fwd_kernel         (called from _fwd, the primal of bicubic_sample): VALUE
//   _bwd_kernel         (called from _bwd, its vjp backward rule): BACKWARD,
//                       which recomputes the taps instead of storing the
//                       derivatives in the forward, as _bwd does
// The function is the same: coordinates clipped to [1, W-2.001] x [1, H-2.001],
// 16 taps of frame fid weighted by the Catmull-Rom weights, 0 where inactive;
// the derivatives are zeroed where the UNCLIPPED x is outside [1, W-2.001) or
// y outside [1, H-2.001). An inactive element gives 0 in every mode (the
// Pallas kernels mask per 512-element chunk, so their inactive outputs are
// unspecified). The TPU design (frame-uniform 512-element chunks,
// 64-row image windows, one-hot row selects on the matrix unit with a bf16
// hi/lo split) is not carried over: the taps here are exact float32 reads.
//
// Bound on the H100: memory traffic. Every element reads its 4 B `active`
// flag and writes 4 B (value), 12 B (value, ddx, ddy) or 8 B (backward);
// only an active one also reads 12 B (fid, x, y), in the backward 4 B of g,
// and 16 image taps, which hit L2, since the
// image stack (8 x 240 x 320 x 4 B =
// 2.5 MB at the benchmark's scale) is far smaller than the 50 MB L2. About 40
// (value) or 110-125 (with derivatives) float operations per active element
// are far below the card's float32 rate.
//
// Design: one thread per element; the per-element arrays are read and written
// coalesced (neighbouring threads, neighbouring addresses); inactive elements
// read only their `active` flag and write zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

enum Mode { VALUE = 0, VALUE_GRAD = 1, BACKWARD = 2 };

template <int MODE>
__global__ void bicubic_rows_kernel(const float* __restrict__ images,
                                    const int32_t* __restrict__ fid,
                                    const float* __restrict__ x,
                                    const float* __restrict__ y,
                                    const float* __restrict__ active,
                                    const float* __restrict__ g,
                                    float* __restrict__ out,
                                    float* __restrict__ ddx,
                                    float* __restrict__ ddy,
                                    int64_t m, int h, int w) {
  constexpr bool WITH_VAL = MODE != BACKWARD;
  constexpr bool WITH_GRAD = MODE != VALUE;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  float val = 0.0f, gx = 0.0f, gy = 0.0f;
  if (__ldg(active + e) > 0.0f) {
    // the clip bounds as float32, the same rounding as the Python side
    const float xmax = (float)((double)w - 2.001);
    const float ymax = (float)((double)h - 2.001);
    const float xe = __ldg(x + e);
    const float ye = __ldg(y + e);
    // fmaxf/fminf keep every tap inside the frame (a NaN coordinate samples
    // the clip corner instead of reading out of bounds)
    const float xc = fminf(fmaxf(xe, 1.0f), xmax);
    const float yc = fminf(fmaxf(ye, 1.0f), ymax);
    const float x0f = floorf(xc);
    const float y0f = floorf(yc);
    float wx[4], wy[4], dwx[4], dwy[4];
    catrom_w(xc - x0f, wx);
    catrom_w(yc - y0f, wy);
    if (WITH_GRAD) {
      catrom_dw(xc - x0f, dwx);
      catrom_dw(yc - y0f, dwy);
    }
    const float* tap = images +
                       ((int64_t)__ldg(fid + e) * h + ((int)y0f - 1)) * (int64_t)w +
                       ((int)x0f - 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* row = tap + (int64_t)j * w;
      float r = 0.0f, rd = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = __ldg(row + i);
        r = fmaf(wx[i], v, r);
        if (WITH_GRAD) rd = fmaf(dwx[i], v, rd);
      }
      if (WITH_VAL) val = fmaf(wy[j], r, val);
      if (WITH_GRAD) {
        gx = fmaf(wy[j], rd, gx);
        gy = fmaf(dwy[j], r, gy);
      }
    }
    if (WITH_GRAD) {
      if (MODE == BACKWARD) {
        const float ge = __ldg(g + e);
        gx *= ge;
        gy *= ge;
      }
      if (!(xe >= 1.0f && xe < xmax)) gx = 0.0f;
      if (!(ye >= 1.0f && ye < ymax)) gy = 0.0f;
    }
  }
  if (WITH_VAL) out[e] = val;
  if (WITH_GRAD) {
    ddx[e] = gx;
    ddy[e] = gy;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// ddx/ddy are written only when with_grad != 0.
extern "C" int i3d_bicubic_rows(const void* images, const void* fid, const void* x,
                                const void* y, const void* active, void* out, void* ddx,
                                void* ddy, long long m, int h, int w, int with_grad,
                                void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((m + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (with_grad) {
    bicubic_rows_kernel<VALUE_GRAD><<<blocks, threads, 0, s>>>(
        (const float*)images, (const int32_t*)fid, (const float*)x, (const float*)y,
        (const float*)active, nullptr, (float*)out, (float*)ddx, (float*)ddy, (int64_t)m, h, w);
  } else {
    bicubic_rows_kernel<VALUE><<<blocks, threads, 0, s>>>(
        (const float*)images, (const int32_t*)fid, (const float*)x, (const float*)y,
        (const float*)active, nullptr, (float*)out, nullptr, nullptr, (int64_t)m, h, w);
  }
  return (int)cudaGetLastError();
}

// The backward of bicubic_sample: dx = g*d/dx, dy = g*d/dy per element.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int i3d_bicubic_sample_bwd(const void* images, const void* fid, const void* x,
                                      const void* y, const void* active, const void* g,
                                      void* dx, void* dy, long long m, int h, int w,
                                      void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((m + threads - 1) / threads);
  bicubic_rows_kernel<BACKWARD><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)images, (const int32_t*)fid, (const float*)x, (const float*)y,
      (const float*)active, (const float*)g, nullptr, (float*)dx, (float*)dy, (int64_t)m, h, w);
  return (int)cudaGetLastError();
}
