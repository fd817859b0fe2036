// Nearest-pixel lookup images[fid, yi, xi] per element, 0 where inactive:
// the depth visibility probe of the observation collection.
//
// Replaces the Pallas TPU kernel _nearest_kernel of
// intrinsic3d_tpu/ops/pallas/bicubic.py (called from nearest_sample_rows).
// The TPU kernel selects the row on the matrix unit with a bf16 hi/lo split
// of the image (an O(2^-16) relative error); here the read is an exact
// float32 load, and the frame-uniform chunk contract and 64-row windows are
// not carried over.
//
// Bound on the H100: memory traffic. Every element reads its 4 B `active`
// flag and writes 4 B; only an active one also reads 12 B (fid, yi, xi) and
// its one image tap, which hits L2 (the depth stack is 2.5 MB at the
// benchmark's scale against a 50 MB L2). There is no arithmetic to speak of.
//
// Design: one thread per element, per-element arrays read and written
// coalesced; inactive elements read only their `active` flag.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void nearest_rows_kernel(const float* __restrict__ images,
                                    const int32_t* __restrict__ fid,
                                    const int32_t* __restrict__ yi,
                                    const int32_t* __restrict__ xi,
                                    const float* __restrict__ active,
                                    float* __restrict__ out, int64_t m, int h, int w) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  float v = 0.0f;
  if (__ldg(active + e) > 0.0f) {
    v = __ldg(images + ((int64_t)__ldg(fid + e) * h + __ldg(yi + e)) * (int64_t)w +
              __ldg(xi + e));
  }
  out[e] = v;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int i3d_nearest_rows(const void* images, const void* fid, const void* yi,
                                const void* xi, const void* active, void* out, long long m,
                                int h, int w, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((m + threads - 1) / threads);
  nearest_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)images, (const int32_t*)fid, (const int32_t*)yi, (const int32_t*)xi,
      (const float*)active, (float*)out, (int64_t)m, h, w);
  return (int)cudaGetLastError();
}
