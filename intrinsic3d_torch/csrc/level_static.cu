// A block level's statics (refine/device_assembly.py::LevelStatic) built on
// the card from the block layout and the grid's per-voxel fields.
//
// Replaces no Pallas kernel: the JAX package builds the statics on the host
// (intrinsic3d_tpu/refine/device_assembly.py::build_level_static, numpy
// scatters over the stencil tables of LevelTopology) and uploads them, and
// so does the port on the CPU (level_static_host + fill_voxel_sh). It was
// added because that host build, and the stencil tables it reads, held the
// main thread and the card idle at every level's join.
//
// The function. Slot s of the dense [nb * S] layout (S = B^3) lies in block
// b = s / S at lane l = s % S = (lx * B + ly) * B + lz; it holds table voxel
// v = slot2vox[s] or none (-1). Per slot:
//   occ[s] = 1 where v exists, valid[s] = 1 where besides weight[v] > 0;
//   vpos[k][s] = block_coords[b][k] * B + l_k (the voxel's coordinates);
//   es_ref[s] = sdf[v]; eg_sh[k][s] = sh[v][k] (k < 9);
//   ea_chroma[a][s] = w(v, u) for the voxel u one step along +axis a, where
//   both exist: the chromaticity weight of albedo pair (v, u)
//   (albedo_regularizer.cpp:60-72, refine/assembly.py::chroma_weights);
// and 0 wherever the voxel (or u) is absent. The +a neighbour's slot is the
// next lane along a inside the block, or lane l_a = 0 of the block row
// nbr27[b][dir(+a)] (nb where the block is absent). occ and valid carry one
// more block row, the pad row, all zero.
//
// The chromaticity weight in numpy's float32 order, every operation one
// IEEE rounding (the _rn intrinsics, so that no multiply-add contraction
// changes a bit): per voxel, c01 = c / 255 by channel, luma = (0.299 r +
// 0.587 g) + 0.114 b on the 0..255 colour with 0 -> 1e-12, chroma = c01 /
// luma; per pair, d = sqrt((d0^2 + d1^2) + d2^2) of the chroma difference,
// w = max(1 - d, 0.01) with a NaN kept, and 0 where w is not finite. The
// constants are numpy's: the doubles rounded to float32. The result is
// level_static_host(...) followed by fill_voxel_sh bit for bit.
//
// What bounds it on the H100: bytes. Its inputs (the voxels' slot, sdf,
// weight, colour and SH, 64 B a voxel, and the block tables) and its outputs
// (72 B a slot) at the benchmark's g0 (1.05 M voxels in 5,744 blocks of 512
// slots) are ~280 MB, 0.08 ms at 3.35 TB/s; the arithmetic is ~40 float
// operations a slot. So the design is two plain passes: one thread a voxel
// writes the slot-to-voxel map (after a memset to -1), then one thread a
// slot writes every output once, coalesced along s, gathering its voxel's
// fields and its 3 neighbours' colours (neighbouring slots hold
// neighbouring voxels, so the L1 and L2 serve most of those reads).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// nbr27's direction index of (dx, dy, dz) is (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1):
// +x 22, +y 16, +z 14
__device__ __forceinline__ int plus_dir(int a) { return a == 0 ? 22 : (a == 1 ? 16 : 14); }

__global__ void __launch_bounds__(kThreads)
    slot_to_voxel_kernel(const int64_t* __restrict__ vox_slot, int n_vox, int* __restrict__ slot2vox) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n_vox) slot2vox[__ldg(vox_slot + i)] = i;
}

// numpy's float32 chromaticity of a 0..255 colour
__device__ __forceinline__ void chroma(const float* __restrict__ color, int v, float out[3]) {
  const float r = __ldg(color + 3 * (int64_t)v), g = __ldg(color + 3 * (int64_t)v + 1),
              b = __ldg(color + 3 * (int64_t)v + 2);
  float luma = __fadd_rn(__fadd_rn(__fmul_rn((float)0.299, r), __fmul_rn((float)0.587, g)),
                         __fmul_rn((float)0.114, b));
  if (luma == 0.0f) luma = (float)1e-12;
  out[0] = __fdiv_rn(__fdiv_rn(r, 255.0f), luma);
  out[1] = __fdiv_rn(__fdiv_rn(g, 255.0f), luma);
  out[2] = __fdiv_rn(__fdiv_rn(b, 255.0f), luma);
}

__device__ __forceinline__ float pair_weight(const float c[3], const float u[3]) {
  const float d0 = __fsub_rn(c[0], u[0]), d1 = __fsub_rn(c[1], u[1]), d2 = __fsub_rn(c[2], u[2]);
  const float d = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2)));
  const float t = __fsub_rn(1.0f, d);
  const float w = (t >= (float)0.01 || t != t) ? t : (float)0.01;  // numpy's maximum: a NaN stays
  return isfinite(w) ? w : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    slot_static_kernel(const int* __restrict__ slot2vox, const int* __restrict__ nbr27,
                       const int64_t* __restrict__ block_coords, const float* __restrict__ sdf,
                       const float* __restrict__ weight, const float* __restrict__ color,
                       const float* __restrict__ sh, int nb, int B, float* __restrict__ occ,
                       float* __restrict__ valid, int* __restrict__ vpos, float* __restrict__ es_ref,
                       float* __restrict__ eg_sh, float* __restrict__ ea_chroma) {
  const int S = B * B * B;
  const int64_t d = (int64_t)nb * S;
  const int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (s >= d + S) return;
  if (s >= d) {  // the pad row of occ and valid
    occ[s] = 0.0f;
    valid[s] = 0.0f;
    return;
  }
  const int v = __ldg(slot2vox + s);
  const int b = (int)(s / S), lane = (int)(s % S);
  const int l[3] = {lane / (B * B), (lane / B) % B, lane % B};
  const int stride[3] = {B * B, B, 1};
  const bool here = v >= 0;
  occ[s] = here ? 1.0f : 0.0f;
  valid[s] = here && __ldg(weight + v) > 0.0f ? 1.0f : 0.0f;
  es_ref[s] = here ? __ldg(sdf + v) : 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    vpos[k * d + s] = here ? (int)(__ldg(block_coords + 3 * (int64_t)b + k) * B + l[k]) : 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) eg_sh[k * d + s] = here ? __ldg(sh + 9 * (int64_t)v + k) : 0.0f;
  float c[3];
  if (here) chroma(color, v, c);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float w = 0.0f;
    if (here) {
      int64_t t = s + stride[a];
      if (l[a] == B - 1) {
        const int nbb = __ldg(nbr27 + 27 * (int64_t)b + plus_dir(a));
        t = nbb < nb ? (int64_t)nbb * S + (lane - (B - 1) * stride[a]) : -1;
      }
      const int u = t >= 0 ? __ldg(slot2vox + t) : -1;
      if (u >= 0) {
        float cu[3];
        chroma(color, u, cu);
        w = pair_weight(c, cu);
      }
    }
    ea_chroma[a * d + s] = w;
  }
}

}  // namespace

// One call on `stream`: the statics of a level of n_vox voxels in nb blocks
// of B^3 slots. Inputs: vox_slot [n_vox] int64 (each in [0, nb * B^3),
// distinct), nbr27 [nb, 27] int32 (nb: absent), block_coords [nb, 3] int64,
// sdf and weight [n_vox], color [n_vox, 3] (0..255) and sh [n_vox, 9]
// float32. Scratch: slot2vox [nb * B^3] int32. Outputs: occ and valid
// [(nb + 1) * B^3], es_ref [nb * B^3], eg_sh [9, nb * B^3] and ea_chroma
// [3, nb * B^3] float32, vpos [3, nb * B^3] int32. All pointers are device
// pointers. A memset and two launches; returns cudaErrorInvalidValue,
// launching nothing, for arguments the kernel does not take, else the
// first error of the memset or cudaGetLastError() after the launches.
extern "C" int i3d_level_static(const void* vox_slot, const void* nbr27, const void* block_coords,
                                const void* sdf, const void* weight, const void* color, const void* sh,
                                int n_vox, int nb, int B, void* slot2vox, void* occ, void* valid, void* vpos,
                                void* es_ref, void* eg_sh, void* ea_chroma, void* stream) {
  if (n_vox < 0 || nb < 0 || B < 1 || B > 64 || (int64_t)(nb + 1) * B * B * B > INT32_MAX ||
      (int64_t)n_vox > (int64_t)nb * B * B * B)
    return (int)cudaErrorInvalidValue;
  const int64_t d = (int64_t)nb * B * B * B;
  const cudaStream_t st = (cudaStream_t)stream;
  if (d > 0) {
    const cudaError_t rc = cudaMemsetAsync(slot2vox, 0xFF, d * sizeof(int), st);
    if (rc != cudaSuccess) return (int)rc;
  }
  if (n_vox > 0)
    slot_to_voxel_kernel<<<(unsigned)((n_vox + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        (const int64_t*)vox_slot, n_vox, (int*)slot2vox);
  const int64_t slots = d + (int64_t)B * B * B;
  slot_static_kernel<<<(unsigned)((slots + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      (const int*)slot2vox, (const int*)nbr27, (const int64_t*)block_coords, (const float*)sdf,
      (const float*)weight, (const float*)color, (const float*)sh, nb, B, (float*)occ, (float*)valid,
      (int*)vpos, (float*)es_ref, (float*)eg_sh, (float*)ea_chroma);
  return (int)cudaGetLastError();
}
