// The element stream shared by the masked per-element samplers
// (nearest_rows.cu; the value and value-plus-derivatives modes of
// bicubic_rows.cu).
//
// Such a sampler reads, per element e of [0, m): a float `active` flag; only
// where it is > 0, three 32-bit words (a frame id and two coordinates) and
// then image taps; and it writes Op::NOUT floats (one for the value and the
// depth probe, three for the value and its two derivatives), 0 where
// inactive. After the L2 cache is cold each of those dependent steps (flag,
// words, taps, stores) is a round trip to HBM of about a microsecond. One
// element per thread with one 4-byte load per step keeps about 132 SMs x
// 2,048 threads x 4 B = 1 MB in flight, a third of the ~3 MB the H100 needs
// to stream at 3.35 TB/s.
//
// rows_vec_kernel: each thread owns V consecutive elements. It reads their
// flags as one 16-byte vector, skips the group when all V are inactive (the
// block-dense layout leaves whole 512-element slots inactive), otherwise
// issues the three word vectors before using any of them, then the V
// elements' taps (`Op::eval<V>`: V elements' flags and words in, NOUT x V
// outputs out, 0 where inactive), and stores each output array's V values
// as one vector: V times the bytes per dependent round trip at about the
// same occupancy. An all-inactive group writes zeros to every output.
//
// Vector loads need 16-byte-aligned addresses. When every array (the flags,
// the three words and each output) is 16-byte aligned (every tensor the
// wrappers allocate is), the body of whole groups takes vector loads and
// stores; otherwise (a contiguous tensor with a storage offset, such as
// t[1:], is only 4-byte aligned) it takes scalar ones, still V independent
// loads a thread. The ragged tail (m mod V elements) is one thread's,
// element by element. One launch per call in every case.
//
// An Op with `OWN_IO = true` (the E_g element pass of eg_rows.cu) reads its
// per-element data and writes its outputs itself: the stream still loads
// the V flags as one vector and skips nothing, but hands the Op the group's
// first element, its flags and whether any is active (`Op::group<V, VEC>`),
// the tail's elements one at a time (`Op::one`), and a per-thread float
// that every thread of the block passes to `Op::block_end` at the end.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace i3d_rows {

template <int V, bool VEC>
__device__ __forceinline__ void load_f(const float* __restrict__ p, float (&r)[V]) {
  if constexpr (VEC) {
    static_assert(V % 4 == 0, "vector loads take groups of 4");
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
      r[4 * i] = q.x;
      r[4 * i + 1] = q.y;
      r[4 * i + 2] = q.z;
      r[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r[i] = __ldg(p + i);
  }
}

template <int V, bool VEC>
__device__ __forceinline__ void load_u(const uint32_t* __restrict__ p, uint32_t (&r)[V]) {
  if constexpr (VEC) {
    static_assert(V % 4 == 0, "vector loads take groups of 4");
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
      r[4 * i] = q.x;
      r[4 * i + 1] = q.y;
      r[4 * i + 2] = q.z;
      r[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r[i] = __ldg(p + i);
  }
}

template <int V, bool VEC>
__device__ __forceinline__ void store_f(float* __restrict__ p, const float (&r)[V]) {
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = r[i];
  }
}

// the per-element arrays of one call: the flags, the three words and the
// NOUT output arrays
template <int NOUT>
struct Arrays {
  const float* active;
  const uint32_t* w0;
  const uint32_t* w1;
  const uint32_t* w2;
  float* out[NOUT];
  int64_t m;
};

// one element through Op, scalar loads (the tail)
template <class Op>
__device__ __forceinline__ void one_element(const typename Op::Params& p, const Arrays<Op::NOUT>& a, int64_t e) {
  float act[1] = {__ldg(a.active + e)};
  float o[Op::NOUT][1];
#pragma unroll
  for (int k = 0; k < Op::NOUT; ++k) o[k][0] = 0.0f;
  if (act[0] > 0.0f) {
    uint32_t w0[1] = {__ldg(a.w0 + e)}, w1[1] = {__ldg(a.w1 + e)}, w2[1] = {__ldg(a.w2 + e)};
    Op::template eval<1>(p, act, w0, w1, w2, o);
  }
#pragma unroll
  for (int k = 0; k < Op::NOUT; ++k) a.out[k][e] = o[k][0];
}

template <class Op, class = void>
struct own_io : std::false_type {};
template <class Op>
struct own_io<Op, std::void_t<decltype(Op::OWN_IO)>> : std::bool_constant<Op::OWN_IO> {};

// Threads [0, ngroups) take the groups of the body [0, V*ngroups); thread
// ngroups takes the tail, one element at a time.
template <class Op, int V, bool VEC>
__global__ void __launch_bounds__(256) rows_vec_kernel(const typename Op::Params p, const Arrays<Op::NOUT> a,
                                                       int64_t ngroups) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (own_io<Op>::value) {
    float acc = 0.0f;
    if (g < ngroups) {
      float act[V];
      load_f<V, VEC>(a.active + g * V, act);
      bool any = false;
#pragma unroll
      for (int v = 0; v < V; ++v) any |= act[v] > 0.0f;
      Op::template group<V, VEC>(p, a, g * V, act, any, acc);
    } else if (g == ngroups) {
      for (int64_t e = ngroups * V; e < a.m; ++e) Op::one(p, a, e, __ldg(a.active + e), acc);
    }
    Op::block_end(p, acc);
  } else if (g < ngroups) {
    const int64_t e0 = g * V;
    float act[V];
    load_f<V, VEC>(a.active + e0, act);
    bool any = false;
#pragma unroll
    for (int v = 0; v < V; ++v) any |= act[v] > 0.0f;
    float o[Op::NOUT][V];
#pragma unroll
    for (int k = 0; k < Op::NOUT; ++k)
#pragma unroll
      for (int v = 0; v < V; ++v) o[k][v] = 0.0f;
    if (any) {
      uint32_t w0[V], w1[V], w2[V];
      load_u<V, VEC>(a.w0 + e0, w0);
      load_u<V, VEC>(a.w1 + e0, w1);
      load_u<V, VEC>(a.w2 + e0, w2);
      Op::template eval<V>(p, act, w0, w1, w2, o);
    }
#pragma unroll
    for (int k = 0; k < Op::NOUT; ++k) store_f<V, VEC>(a.out[k] + e0, o[k]);
  } else if (g == ngroups) {
    for (int64_t e = ngroups * V; e < a.m; ++e) one_element<Op>(p, a, e);
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Launches rows_vec_kernel over the m elements of `a` on `stream`; returns
// cudaGetLastError() (0 = launched).
template <class Op, int V>
int launch_rows(const typename Op::Params& p, const Arrays<Op::NOUT>& a, cudaStream_t stream) {
  if (a.m <= 0) return (int)cudaSuccess;
  const int64_t ngroups = a.m / V;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((ngroups + 1 + threads - 1) / threads);
  bool vec = aligned16(a.active) && aligned16(a.w0) && aligned16(a.w1) && aligned16(a.w2);
  for (int k = 0; k < Op::NOUT; ++k) vec = vec && aligned16(a.out[k]);
  if (vec)
    rows_vec_kernel<Op, V, true><<<blocks, threads, 0, stream>>>(p, a, ngroups);
  else
    rows_vec_kernel<Op, V, false><<<blocks, threads, 0, stream>>>(p, a, ngroups);
  return (int)cudaGetLastError();
}

}  // namespace i3d_rows
