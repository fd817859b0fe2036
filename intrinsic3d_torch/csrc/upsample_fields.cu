// Field resampling of the grid-level x2 upsample: every child voxel's fields
// trilinearly from its parent's 8 corners, written straight in the child
// grid's key order.
//
// Replaces no Pallas kernel: the JAX package's upsample
// (intrinsic3d_tpu/grid/algorithms.py::upsample, _upsample_fields) is host
// numpy, and so is the port's plain route (grid/algorithms.py). It was added
// because that numpy pass held the card idle between two grid levels.
//
// The function, per child j in key order: o = order[j] is its index in
// parent-major order, p = o / 8 its parent and c = o % 8 its corner offset
// (child coordinates 2 * parent + offset). Corner k of parent p is the voxel
// idx[p][k] (-1: absent), valid when present and of weight > 0. Its weight is
// the fixed table w(c, k) = prod over the axes of (k's offset 1 ? c's / 2 :
// 1 - c's / 2) where valid, else 0; a corner absent or invalid still reads
// the voxel max(idx, 0), times 0. A scalar field (sdf, weight, albedo,
// sdf_refined) is the pairwise sum ((t0 + t1) + (t2 + t3)) + ((t4 + t5) +
// (t6 + t7)) of the products t_k = v_k * w_k, a colour channel the
// sequential sum t0 + t1 + ... + t7, each divided by the weights' sum (1
// where it is 0); the weight is 0 where at most 4 corners are valid, and
// then max(weight, 0) with a NaN kept. That is numpy's arithmetic in
// _upsample_fields, operation for operation: every product, sum and
// quotient is one IEEE float32 rounding, written with the _rn intrinsics so
// that no multiply-add contraction changes a bit, and the result is the
// host path's bit for bit.
//
// What bounds it on the H100: bytes. It does ~140 float operations a child
// against 32 B of order and outputs a child plus the parents' corner table
// and fields; at the g1 -> g0 boundary of the benchmark's capture (261 k
// parents, 2.09 M children) ~83 MB, 0.025 ms at 3.35 TB/s. The gathers
// repeat: the 8 children of a parent read its corner row, and a voxel is a
// corner of up to 8 parents. Children in key order lie next to their key
// neighbours, whose parents are neighbours too, so a block's gathers fall on
// few parents and rows, which the L1 and L2 keep; the parents' fields (7.3
// MB at g1 -> g0) and corner table (8.4 MB) fit the 50 MB L2 whole. So the
// design is one thread a child with plain read-only loads, the corner row
// as two 16-byte loads, and each output written once, coalesced along j.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// corner k's offset as the bits x | y << 1 | z << 2, in the order of
// CORNER_OFFS in ops/upsample.py (and of the children's offsets c):
// 0, 1, 2, 4, 3, 6, 5, 7, a nibble each
__host__ __device__ constexpr int corner_bits(int k) { return (0x75634210u >> (4 * k)) & 7; }

__device__ __forceinline__ float tree8(const float* t) {
  return __fadd_rn(__fadd_rn(__fadd_rn(t[0], t[1]), __fadd_rn(t[2], t[3])),
                   __fadd_rn(__fadd_rn(t[4], t[5]), __fadd_rn(t[6], t[7])));
}

// the scalar field f at the 8 corners, resampled
__device__ __forceinline__ float scalar_avg(const float* __restrict__ f, const int* at, const float* w,
                                            float wsafe) {
  float t[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) t[k] = __fmul_rn(__ldg(f + at[k]), w[k]);
  return __fdiv_rn(tree8(t), wsafe);
}

template <bool SBR>
__global__ void __launch_bounds__(kThreads)
    upsample_fields_kernel(const float* __restrict__ sdf, const float* __restrict__ weight,
                           const float* __restrict__ color, const float* __restrict__ albedo,
                           const float* __restrict__ sdf_refined, const int* __restrict__ idx,
                           const int* __restrict__ order, int n_child, float* __restrict__ out_sdf,
                           float* __restrict__ out_weight, float* __restrict__ out_color,
                           float* __restrict__ out_albedo, float* __restrict__ out_sdf_refined) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_child) return;
  const int o = __ldg(order + j);
  const int cbits = corner_bits(o & 7);
  const int4* row = reinterpret_cast<const int4*>(idx) + 2 * (int64_t)(o >> 3);
  const int4 lo = __ldg(row), hi = __ldg(row + 1);
  const int nb[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};

  int at[8];
  float w[8];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    at[k] = max(nb[k], 0);
    const bool valid = nb[k] >= 0 && __ldg(weight + at[k]) > 0.0f;
    cnt += valid;
    // the table's factors are 0, 0.5 or 1: every product is exact
    float wk = 1.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const bool ck = (cbits >> a) & 1;
      const float f = ((corner_bits(k) >> a) & 1) ? (ck ? 0.5f : 0.0f) : (ck ? 0.5f : 1.0f);
      wk = __fmul_rn(wk, f);
    }
    w[k] = valid ? wk : 0.0f;
  }
  const float wsum = tree8(w);
  const float wsafe = wsum > 0.0f ? wsum : 1.0f;

  out_sdf[j] = scalar_avg(sdf, at, w, wsafe);
  const float wt = cnt > 4 ? scalar_avg(weight, at, w, wsafe) : 0.0f;
  out_weight[j] = (wt >= 0.0f || wt != wt) ? wt : 0.0f;  // numpy's maximum(wt, 0): a NaN stays
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float s = __fmul_rn(__ldg(color + 3 * (int64_t)at[0] + ch), w[0]);
#pragma unroll
    for (int k = 1; k < 8; ++k) s = __fadd_rn(s, __fmul_rn(__ldg(color + 3 * (int64_t)at[k] + ch), w[k]));
    out_color[3 * (int64_t)j + ch] = __fdiv_rn(s, wsafe);
  }
  if (SBR) {
    out_albedo[j] = scalar_avg(albedo, at, w, wsafe);
    out_sdf_refined[j] = scalar_avg(sdf_refined, at, w, wsafe);
  }
}

}  // namespace

// One launch on `stream` over the n_child children of n_parent parents
// (n_child = 8 * n_parent): the parents' float32 fields sdf, weight,
// albedo, sdf_refined [n_parent] and color [n_parent, 3], the corner table
// idx [n_parent, 8] and the key order `order` [n_child] (int32, each in
// [0, n_child)); the children's fields, in key order, into the out_*
// arrays of the same layouts. albedo, sdf_refined and their outputs are
// null for a grid without them. All pointers are device pointers, idx
// 16-byte aligned. Returns cudaErrorInvalidValue, launching nothing, for
// arguments the kernel does not take, else cudaGetLastError() after the
// launch.
extern "C" int i3d_upsample_fields(const void* sdf, const void* weight, const void* color, const void* albedo,
                                   const void* sdf_refined, const void* idx, const void* order, int n_parent,
                                   void* out_sdf, void* out_weight, void* out_color, void* out_albedo,
                                   void* out_sdf_refined, void* stream) {
  if (n_parent < 0 || (int64_t)n_parent * 8 > INT32_MAX || ((uintptr_t)idx & 15) != 0 ||
      (albedo == nullptr) != (sdf_refined == nullptr) || (albedo == nullptr) != (out_albedo == nullptr) ||
      (sdf_refined == nullptr) != (out_sdf_refined == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_parent == 0) return (int)cudaSuccess;
  const int n_child = 8 * n_parent;
  const dim3 grid((unsigned)((n_child + kThreads - 1) / kThreads));
  const cudaStream_t st = (cudaStream_t)stream;
  const float* f[5] = {(const float*)sdf, (const float*)weight, (const float*)color, (const float*)albedo,
                       (const float*)sdf_refined};
  float* g[5] = {(float*)out_sdf, (float*)out_weight, (float*)out_color, (float*)out_albedo,
                 (float*)out_sdf_refined};
  if (albedo != nullptr)
    upsample_fields_kernel<true><<<grid, kThreads, 0, st>>>(f[0], f[1], f[2], f[3], f[4], (const int*)idx,
                                                             (const int*)order, n_child, g[0], g[1], g[2],
                                                             g[3], g[4]);
  else
    upsample_fields_kernel<false><<<grid, kThreads, 0, st>>>(f[0], f[1], f[2], f[3], f[4], (const int*)idx,
                                                              (const int*)order, n_child, g[0], g[1], g[2],
                                                              g[3], g[4]);
  return (int)cudaGetLastError();
}
