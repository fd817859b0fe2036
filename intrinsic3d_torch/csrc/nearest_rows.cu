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
// its one image tap, which hits L2 once the depth stack (2.5 MB at the
// benchmark's scale) is there. There is no arithmetic to speak of.
//
// What held the first design back (one thread per element, 256-thread
// blocks): each thread made one 4-byte load per dependent step (flag, then
// indices, then tap, then store), so with a cold L2 about 1 MB was in flight
// per step where the card needs ~3 MB. It reached 82% of its bound on large
// all-active inputs and 38% on the benchmark's (PERF.md, with cold L2).
//
// Design: the element stream of rows_common.cuh with V = 4 elements a
// thread: one 16-byte vector load of the flags, then, unless all four are
// inactive, the three index vectors before any is used, the four taps
// together and one vector store. A persistent kernel fed by bulk
// asynchronous copies into a shared-memory ring, 8 elements a thread and 2
// groups of 4 a thread were built and measured beside it and lost on every
// main-path input (PERF.md §6). What remains on small calls is the chain
// of dependent round trips itself: about 7 us of a cold call whatever its
// size, more than the bounds of the coarse levels' calls.

#include "rows_common.cuh"

namespace {

struct NearestOp {
  static constexpr int NOUT = 1;
  struct Params {
    const float* images;
    int h, w;
  };
  template <int V>
  __device__ static __forceinline__ void eval(const Params& p, const float (&act)[V], const uint32_t (&fid)[V],
                                              const uint32_t (&yi)[V], const uint32_t (&xi)[V], float (&o)[1][V]) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      o[0][v] = act[v] > 0.0f ? __ldg(p.images + ((int64_t)(int32_t)fid[v] * p.h + (int32_t)yi[v]) * (int64_t)p.w +
                                      (int32_t)xi[v])
                              : 0.0f;
  }
};

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int i3d_nearest_rows(const void* images, const void* fid, const void* yi, const void* xi,
                                const void* active, void* out, long long m, int h, int w, void* stream) {
  return i3d_rows::launch_rows<NearestOp, 4>(
      {(const float*)images, h, w},
      {(const float*)active, (const uint32_t*)fid, (const uint32_t*)yi, (const uint32_t*)xi, {(float*)out},
       (int64_t)m},
      (cudaStream_t)stream);
}
