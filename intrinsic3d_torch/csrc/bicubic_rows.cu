// Masked Catmull-Rom bicubic sampling of a [K, H, W] float32 image stack at
// per-element (fid, x, y), in three modes: the value (BicubicValueOp over
// the element stream of rows_common.cuh); the value and the two directional
// derivatives d/dx and d/dy (BicubicValueGradOp over the same stream); and,
// given a per-element cotangent g, g*d/dx and g*d/dy without the value
// (bicubic_rows_kernel).
//
// Replaces the Pallas TPU kernels of intrinsic3d_tpu/ops/pallas/bicubic.py:
//   _win_fwd_kernel     (called from _call_fwd,     the primal of bicubic_sample_rows)
//   _win_fwdgrad_kernel (called from _call_fwdgrad, its vjp forward rule _rows_fwd_rule)
//   _fwd_kernel         (called from _fwd, the primal of bicubic_sample): the value
//   _bwd_kernel         (called from _bwd, its vjp backward rule): the
//                       backward, which recomputes the taps instead of storing the
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
// What held the first design of the value and the value-plus-derivatives
// modes back (one thread per element, 256-thread blocks): each thread made
// one 4-byte load per dependent step (flag, then coordinates, then taps,
// then stores), so with a cold L2 about 1 MB was in flight per step where
// the card needs ~3 MB; the value ran at 50% and the derivatives at 61% of
// their bounds on the benchmark's input (PERF.md, with cold L2). The main
// path's sampler calls are 0.1-7% active, in long inactive runs, so they
// mostly stream flags and zeros (three zero streams with the derivatives).
//
// Design. Both forward modes run the element stream of rows_common.cuh with
// V = 4 elements a thread: one 16-byte vector load of the flags, then,
// unless all four are inactive, the fid, x and y vectors before any is
// used, then the active elements one after another, each one's 16 taps
// issued together, and one vector store per output array (one for the
// value, three with the derivatives). With the derivatives each element
// takes two passes, the weights and the taps and then the sums, which
// keeps its 16 tap loads back to back in the compiled code. Their
// arithmetic is the first kernel's to the bit: the same catrom_w and
// catrom_dw, the same fmaf order (r and rd over a row's taps, then val, gx
// and gy over the rows), the same fminf/fmaxf clip (a NaN coordinate
// samples the clip corner) and the same masks on the unclipped
// coordinates.
//
// Candidates that lost (PERF.md §6). For the value: a persistent
// bulk-copy kernel, 8 elements a thread, 2 groups of 4 a thread, 16-byte
// tap loads, and all four elements' 64 taps issued at once. For the value
// and derivatives: one pass per element (48 registers; the compiler spread
// each element's tap loads among the FMAs that use them, so an element
// paid several dependent round trips: 56-62% slower than the first kernel
// on short all-active inputs with scattered taps); one row of 4 taps at a
// time (the same); two or four elements' taps at once (73-93 registers and
// more, slower on the benchmark's input); and register caps of 40, 48 and
// 64 (spills). On all-active input the 16 scalar tap loads an element, not
// the bytes, limit both modes (about half to three quarters of the bound).
// The backward keeps the first kernel (bicubic_rows_kernel): one thread per
// element; the per-element arrays are read and written coalesced; inactive
// elements read only their `active` flag and write zeros.

#include "rows_common.cuh"

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

// The value through the element stream, element for element the arithmetic
// of the first design's value-only mode: catrom_w, then the fmaf order
// (rows, then columns)
struct BicubicValueOp {
  static constexpr int NOUT = 1;
  struct Params {
    const float* images;
    int h, w;
  };
  template <int V>
  __device__ static __forceinline__ void eval(const Params& p, const float (&act)[V], const uint32_t (&fid)[V],
                                              const uint32_t (&xs)[V], const uint32_t (&ys)[V], float (&o)[1][V]) {
    // the clip bounds as float32, the same rounding as the Python side
    const float xmax = (float)((double)p.w - 2.001);
    const float ymax = (float)((double)p.h - 2.001);
    // one element after another, each active element's 16 taps issued
    // together: 40 registers, where issuing all V elements' taps at once
    // took 48-64 and fewer blocks an SM (PERF.md §6)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float val = 0.0f;
      if (act[v] > 0.0f) {
        const float xc = fminf(fmaxf(__uint_as_float(xs[v]), 1.0f), xmax);
        const float yc = fminf(fmaxf(__uint_as_float(ys[v]), 1.0f), ymax);
        const float x0f = floorf(xc);
        const float y0f = floorf(yc);
        float wx[4], wy[4];
        catrom_w(xc - x0f, wx);
        catrom_w(yc - y0f, wy);
        const float* tap =
            p.images + ((int64_t)(int32_t)fid[v] * p.h + ((int)y0f - 1)) * (int64_t)p.w + ((int)x0f - 1);
        float t[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) t[k] = __ldg(tap + (int64_t)(k / 4) * p.w + (k % 4));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float r = 0.0f;
#pragma unroll
          for (int i = 0; i < 4; ++i) r = fmaf(wx[i], t[4 * j + i], r);
          val = fmaf(wy[j], r, val);
        }
      }
      o[0][v] = val;
    }
  }
};

// The value and both derivatives through the element stream, element for
// element the arithmetic of the first design's value-and-derivatives mode:
// catrom_w and catrom_dw on both axes, r and rd over each row's taps, then
// val, gx and gy over the rows, then the masks on the unclipped coordinates.
// Each element takes two passes, each under its own test of the flag: the
// weights and the 16 taps, then the sums (64 registers; one pass took 48
// and ran slower, PERF.md §6)
struct BicubicValueGradOp {
  static constexpr int NOUT = 3;
  using Params = BicubicValueOp::Params;
  template <int V>
  __device__ static __forceinline__ void eval(const Params& p, const float (&act)[V], const uint32_t (&fid)[V],
                                              const uint32_t (&xs)[V], const uint32_t (&ys)[V], float (&o)[3][V]) {
    // the clip bounds as float32, the same rounding as the Python side
    const float xmax = (float)((double)p.w - 2.001);
    const float ymax = (float)((double)p.h - 2.001);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float xe = __uint_as_float(xs[v]);
      const float ye = __uint_as_float(ys[v]);
      float t[16], wx[4], wy[4], dwx[4], dwy[4];
      if (act[v] > 0.0f) {
        const float xc = fminf(fmaxf(xe, 1.0f), xmax);
        const float yc = fminf(fmaxf(ye, 1.0f), ymax);
        const float x0f = floorf(xc);
        const float y0f = floorf(yc);
        catrom_w(xc - x0f, wx);
        catrom_w(yc - y0f, wy);
        catrom_dw(xc - x0f, dwx);
        catrom_dw(yc - y0f, dwy);
        const float* tap =
            p.images + ((int64_t)(int32_t)fid[v] * p.h + ((int)y0f - 1)) * (int64_t)p.w + ((int)x0f - 1);
#pragma unroll
        for (int k = 0; k < 16; ++k) t[k] = __ldg(tap + (int64_t)(k / 4) * p.w + (k % 4));
      }
      float val = 0.0f, gx = 0.0f, gy = 0.0f;
      if (act[v] > 0.0f) {
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
      o[0][v] = val;
      o[1][v] = gx;
      o[2][v] = gy;
    }
  }
};

// g*d/dx and g*d/dy of the value, one thread per element (the first
// design, kept for the backward)
__global__ void bicubic_rows_kernel(const float* __restrict__ images,
                                    const int32_t* __restrict__ fid,
                                    const float* __restrict__ x,
                                    const float* __restrict__ y,
                                    const float* __restrict__ active,
                                    const float* __restrict__ g,
                                    float* __restrict__ ddx,
                                    float* __restrict__ ddy,
                                    int64_t m, int h, int w) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  float gx = 0.0f, gy = 0.0f;
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
    catrom_dw(xc - x0f, dwx);
    catrom_dw(yc - y0f, dwy);
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
        rd = fmaf(dwx[i], v, rd);
      }
      gx = fmaf(wy[j], rd, gx);
      gy = fmaf(dwy[j], r, gy);
    }
    const float ge = __ldg(g + e);
    gx *= ge;
    gy *= ge;
    if (!(xe >= 1.0f && xe < xmax)) gx = 0.0f;
    if (!(ye >= 1.0f && ye < ymax)) gy = 0.0f;
  }
  ddx[e] = gx;
  ddy[e] = gy;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// ddx/ddy are written only when with_grad != 0.
extern "C" int i3d_bicubic_rows(const void* images, const void* fid, const void* x,
                                const void* y, const void* active, void* out, void* ddx,
                                void* ddy, long long m, int h, int w, int with_grad,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* act = (const float*)active;
  const uint32_t *f = (const uint32_t*)fid, *xs = (const uint32_t*)x, *ys = (const uint32_t*)y;
  if (with_grad)
    return i3d_rows::launch_rows<BicubicValueGradOp, 4>(
        {(const float*)images, h, w}, {act, f, xs, ys, {(float*)out, (float*)ddx, (float*)ddy}, (int64_t)m}, s);
  return i3d_rows::launch_rows<BicubicValueOp, 4>({(const float*)images, h, w},
                                                  {act, f, xs, ys, {(float*)out}, (int64_t)m}, s);
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
  bicubic_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)images, (const int32_t*)fid, (const float*)x, (const float*)y,
      (const float*)active, (const float*)g, (float*)dx, (float*)dy, (int64_t)m, h, w);
  return (int)cudaGetLastError();
}
