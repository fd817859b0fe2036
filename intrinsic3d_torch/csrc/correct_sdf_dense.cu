// Jacobi distance-transform sweeps over a dense [X, Y, Z] float32 SDF window
// (z contiguous) with its weight field, 0 meaning absent or unseen.
//
// Replaces the Pallas TPU kernel of
// intrinsic3d_tpu/ops/pallas/distance_transform.py: `kernel` inside
// _correct_chunk (the pallas_call of correct_sdf_dense), whose body is
// _sweep. The function is the same: each sweep, a voxel with weight > 0
// takes the candidate nb + sgn(nb)*step[k] of the first of its 26 neighbours
// (offsets in dx, dy, dz loop order over -1, 0, 1) that is valid, has the
// same sign and gives |cand| below the best so far (which starts at |sdf|);
// a voxel that takes a candidate gets weight 1. Neighbours outside the
// window are invalid. A sweep reads only the previous sweep's fields
// (Jacobi), so the sweeps ping-pong between two buffer pairs; updating in
// place would make it Gauss-Seidel, a different function. The 26 step
// lengths come from the host, computed there as the float32 product
// float32(|off|) * voxel_size exactly as the JAX package does; nb +/- step
// is one rounding, so contraction cannot change it.
//
// Bound on the H100: the float/compare work. A sweep reads and writes
// 16 B per voxel when the window is cold, and the 26 neighbour reads hit L1
// and L2; 10 sweeps x 26 neighbours x ~8 operations per valid voxel are
// above that byte count over 3.35 TB/s. The TPU design's point, fusing all
// sweeps in on-chip memory behind an iters-deep halo, is not carried over
// in this first kernel: one thread per voxel, one sweep per launch, `iters`
// launches on one stream with no host sync between them. The fused
// shared-memory tile is recorded in ROADMAP.md as the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Steps {
  float d[26];
};

__global__ void correct_sdf_sweep_kernel(const float* __restrict__ sdf,
                                         const float* __restrict__ weight,
                                         float* __restrict__ out_sdf,
                                         float* __restrict__ out_weight,
                                         int nx, int ny, int nz, Steps steps) {
  const int64_t n = (int64_t)nx * ny * nz;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const float s = sdf[e];
  const float w = weight[e];
  float best_val = s;
  float best_abs = fabsf(s);
  bool updated = false;
  if (w > 0.0f) {
    const int z = (int)(e % nz);
    const int64_t xy = e / nz;
    const int y = (int)(xy % ny);
    const int x = (int)(xy / ny);
    const bool pos = s >= 0.0f;
    int k = 0;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dz = -1; dz <= 1; ++dz) {
          if (dx == 0 && dy == 0 && dz == 0) continue;
          const float step = steps.d[k++];
          const int xn = x + dx, yn = y + dy, zn = z + dz;
          if (xn < 0 || xn >= nx || yn < 0 || yn >= ny || zn < 0 || zn >= nz) continue;
          const int64_t en = e + ((int64_t)dx * ny + dy) * nz + dz;
          if (!(weight[en] > 0.0f)) continue;
          const float nb = sdf[en];
          const bool pos_nb = nb >= 0.0f;
          if (pos_nb != pos) continue;
          const float cand = pos_nb ? nb + step : nb - step;
          const float a = fabsf(cand);
          if (a < best_abs) {
            best_val = cand;
            best_abs = a;
            updated = true;
          }
        }
      }
    }
  }
  out_sdf[e] = best_val;
  out_weight[e] = updated ? 1.0f : w;
}

}  // namespace

// Runs `iters` sweeps on `stream`, one launch each, reading (sdf, weight)
// and leaving the result in (out_sdf, out_weight); (tmp_sdf, tmp_weight) is
// the second buffer pair of the ping-pong. The inputs are not written.
// `steps` points to 26 floats in host memory. Returns cudaGetLastError()
// after the first failed launch, or 0 when every launch was accepted.
extern "C" int i3d_correct_sdf_dense(const void* sdf, const void* weight, void* out_sdf,
                                     void* out_weight, void* tmp_sdf, void* tmp_weight,
                                     int nx, int ny, int nz, int iters, const float* steps,
                                     void* stream) {
  const int64_t n = (int64_t)nx * ny * nz;
  if (n <= 0 || iters <= 0) return (int)cudaSuccess;
  Steps st;
  for (int k = 0; k < 26; ++k) st.d[k] = steps[k];
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const float* src_s = (const float*)sdf;
  const float* src_w = (const float*)weight;
  for (int it = 0; it < iters; ++it) {
    // the last sweep writes `out`; earlier ones alternate so no sweep reads
    // the buffer it writes
    const bool to_out = ((iters - 1 - it) % 2) == 0;
    float* dst_s = (float*)(to_out ? out_sdf : tmp_sdf);
    float* dst_w = (float*)(to_out ? out_weight : tmp_weight);
    correct_sdf_sweep_kernel<<<blocks, threads, 0, s>>>(src_s, src_w, dst_s, dst_w, nx, ny, nz,
                                                        st);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src_s = dst_s;
    src_w = dst_w;
  }
  return (int)cudaSuccess;
}
