// Jacobi distance-transform sweeps over a dense [X, Y, Z] float32 SDF window
// (z contiguous) with its weight field, 0 meaning absent or unseen; several
// sweeps fused in shared memory per launch.
//
// Replaces the Pallas TPU kernel of
// intrinsic3d_tpu/ops/pallas/distance_transform.py: `kernel` inside
// _correct_chunk (the pallas_call of correct_sdf_dense), whose body is
// _sweep. The function is the same: each sweep, a voxel with weight > 0
// takes the candidate nb + sgn(nb)*step[k] of the 26 neighbours (offsets in
// dx, dy, dz over -1, 0, 1) that is valid, has its sign and gives the least
// |cand| below |sdf|; a voxel that takes a candidate gets weight 1.
// Neighbours outside the window are invalid. Sweeps are Jacobi: each reads
// only the previous sweep's field.
//
// What bounds it on the H100. The bytes bound is 16 B per voxel in and out
// once. A kernel of one sweep per launch moves them once per sweep, so on a
// field of the size users fuse (411x211x501, 2% valid) it is 10 passes over
// device memory; this kernel makes ceil(10 / S). What holds it above that
// bound is each block's march: a step of the march waits at one barrier for
// the block's slowest warp, and a warp works through the live items of its
// S levels one after another. On the fusion path's 73x63x73 window (a
// third valid, in L2) the march is short and its steps are also bound by
// the shared-memory reads of the valid items (9 a row and plane). So the
// plan (ops/distance_transform.py) fuses few sweeps on short segments for
// windows up to 20 M voxels, and more on long segments for larger ones.
//
// The design. A block owns an interior (y, z) tile and a segment of x and
// marches along x (the outermost axis, so each row of a plane is a
// coalesced run of z). It fuses S sweeps: level 0 is the launch's input,
// level s the field after s sweeps, and level s is computed on the tile
// plus a halo of S - s voxels. Information moves one voxel per sweep in the
// 26-neighbourhood, so every voxel a level computes is exact (the argument
// of distance_transform.py:9-15), and the interior of level S is the
// output. Level s works on the plane 2s behind level 0, so the three planes
// of level s - 1 it reads were written at earlier steps, and a ring of 4
// planes per level with one __syncthreads per step suffices. Each lane owns
// V rows of one column at every level and loads its points of the next
// input plane into registers a step ahead (plain loads: the window's z
// extent, 73 or 501 floats, is no multiple of 16 B, so TMA is not used).
//
// Validity never changes during the sweeps, so a level stores only the sdf,
// an invalid voxel as NaN and -0 as +0: a NaN neighbour fails the sign test
// as an invalid one does, a valid voxel whose sdf is NaN never updates nor
// updates a neighbour, and -0 and +0 give the same candidates. A warp whose
// points of a plane are all invalid skips that plane at every level, and
// writes NaN into a level's ring slot only when the slot held something
// else. Candidates are |nb| + step for the voxel's sign, one rounding as
// nb +/- step is in the plain version, and rounding is monotonic, so the
// least candidate of the 6 face, 12 edge and 8 corner neighbours is the
// least |nb| of the class plus its step. The least |nb| of the voxel's sign
// is an integer min of the bits: unsigned for sdf >= 0 (negative floats
// and NaN have larger bit patterns than +inf), signed for sdf < 0 (the
// negative float nearest 0 has the least signed pattern, and non-negatives
// and NaN lose). A warp whose valid voxels share a sign takes one kind of
// min, a mixed warp both. The order of the neighbours does not change the
// value, so the output is the plain version's bit for bit. The output is
// written as the input (sdf, weight) of each interior voxel when its plane
// arrives, and again as (level S, 1) where some sweep lowered |sdf|, a bit
// per row and level that the lane carries in a register.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 768;
constexpr int V = 4;  // rows of a column a lane sweeps
constexpr unsigned kPosMax = 0x7f800000u;    // +inf: unsigned keys up to it are non-negative floats
constexpr int kNegMax = (int)0xff800000u;     // -inf: signed keys up to it are negative floats

// Integer keys of a float whose least value over the neighbours of the
// voxel's sign is the least |nb| of that sign: the bits as unsigned for
// sdf >= 0, as signed for sdf < 0. `lim` is the key of the infinity of that
// sign, which every key of a neighbour of the other sign, or NaN, exceeds;
// `mag` is |nb| of a key no greater than `lim`.
template <bool NEG>
struct Key;
template <>
struct Key<false> {
  using T = unsigned;
  static __device__ __forceinline__ T of(float v) { return __float_as_uint(v); }
  static __device__ __forceinline__ T lim() { return kPosMax; }
  static __device__ __forceinline__ float mag(T k) { return __uint_as_float(k); }
};
template <>
struct Key<true> {
  using T = int;
  static __device__ __forceinline__ T of(float v) { return __float_as_int(v); }
  static __device__ __forceinline__ T lim() { return kNegMax; }
  static __device__ __forceinline__ float mag(T k) { return -__int_as_float(k); }
};

// The least candidate |cand| of each of V rows of one column over its
// neighbours of sign NEG, +inf where none: `pl` the three planes of level
// s - 1, `row` the offsets of rows -1 .. V around them, `col` the column.
// Per row, the centre keys of the outer planes and the z-side keys of each
// plane are reduced once: a face neighbour is an outer plane's centre (same
// row), plane 0's centre (row +/- 1) or plane 0's side (same row); an edge
// one an outer centre (row +/- 1), an outer side (same row) or plane 0's
// side (row +/- 1); a corner one an outer side (row +/- 1).
template <bool NEG>
__device__ __forceinline__ void least_candidates(const float* const (&pl)[3], const int (&row)[V + 2], int col,
                                                 const float (&d)[3], float (&best)[V]) {
  using K = Key<NEG>;
  typename K::T c0[V + 2], cpm[V + 2], s0[V + 2], spm[V + 2];
#pragma unroll
  for (int k = 0; k < V + 2; ++k) {
    const int i = row[k] + col;
    c0[k] = K::of(pl[1][i]);
    cpm[k] = min(K::of(pl[0][i]), K::of(pl[2][i]));
    s0[k] = min(K::of(pl[1][i - 1]), K::of(pl[1][i + 1]));
    spm[k] = min(min(K::of(pl[0][i - 1]), K::of(pl[0][i + 1])), min(K::of(pl[2][i - 1]), K::of(pl[2][i + 1])));
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int y = j + 1;
    const typename K::T face = min(min(min(cpm[y], s0[y]), min(c0[y - 1], c0[y + 1])), K::lim());
    const typename K::T edge =
        min(min(min(cpm[y - 1], cpm[y + 1]), min(spm[y], min(s0[y - 1], s0[y + 1]))), K::lim());
    const typename K::T corner = min(min(spm[y - 1], spm[y + 1]), K::lim());
    best[j] = fminf(fminf(__fadd_rn(K::mag(face), d[0]), __fadd_rn(K::mag(edge), d[1])),
                    __fadd_rn(K::mag(corner), d[2]));
  }
}

// One launch of S sweeps. Block (bx, by, bz): interior columns bx*TZ ..,
// rows by*TY .., planes bz*seg ..; level 0 covers EY = TY + 2S rows and
// EZ = TZ + 2S columns (EZ = 32 * C). Warp (rw, c) owns column chunk c
// (lane = column within it) and rows V*rw .. V*rw + V - 1 at every level,
// so a lane copies, converts and sweeps the same points throughout.
__global__ void __launch_bounds__(kMaxThreads) fused_sweeps_kernel(
    const float* __restrict__ sdf, const float* __restrict__ weight, float* __restrict__ out_sdf,
    float* __restrict__ out_weight, int nx, int ny, int nz, int S, int TY, int EZ, int seg, float d_face,
    float d_edge, float d_corner) {
  extern __shared__ float smem[];
  const int C = EZ >> 5, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = warp % C, col = 32 * c + lane, row0 = V * (warp / C);
  const int EY = TY + 2 * S, TZ = EZ - 2 * S, plane0 = EY * EZ;
  float* lev = smem;  // level s: 4 slots of (EY - 2s) * EZ from lev + 4 EZ (s EY - s(s-1))
  const float d[3] = {d_face, d_edge, d_corner};
  const float nan = __uint_as_float(0x7fc00000u);
  const unsigned full = 0xffffffffu, vmask = (1u << V) - 1;

  const int z0 = (int)blockIdx.x * TZ - S, y0 = (int)blockIdx.y * TY - S;
  const int xi0 = (int)blockIdx.z * seg, L = min(seg, nx - xi0), xb = xi0 - S;
  const int n0 = L + 2 * S;  // level-0 planes; level s computes planes s .. n0 - s - 1
  const int z = z0 + col;
  const bool z_in = z >= 0 && z < nz, col_out = col >= S && col < S + TZ && z_in;
  const int64_t nyz = (int64_t)ny * nz;
  int goff[V];                          // y * nz + z of row j
  unsigned in_rows = 0, out_rows = 0;   // bit j: row j inside the window; an interior row to write
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int row = row0 + j, y = y0 + row;
    const bool in = z_in && row < EY && y >= 0 && y < ny;
    goff[j] = in ? y * nz + z : 0;
    in_rows |= (unsigned)in << j;
    out_rows |= (unsigned)(col_out && row >= S && row < S + TY && y < ny) << j;
  }

  float in_s[V], in_w[V];  // this lane's points of the next input plane, loaded a step ahead
  auto load = [&](int r) {
    const int x = xb + r;
    const bool x_in = x >= 0 && x < nx;
    const int64_t base = x_in ? x * nyz : 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const bool in = x_in && ((in_rows >> j) & 1u);
      in_s[j] = in ? __ldg(sdf + base + goff[j]) : 0.0f;
      in_w[j] = in ? __ldg(weight + base + goff[j]) : 0.0f;
    }
  };
  load(0);
  uint64_t live = 0;      // bit a: level-0 plane t - a had a valid point among this warp's (warp-uniform)
  uint32_t nan_slots = 0; // bit 4s + q: this warp's rows of level s's ring slot q hold only NaN (warp-uniform)
  uint64_t took = 0;      // bits (2s + (r & 1)) V + j: row j took a candidate in some sweep <= s, plane r
  const int nsteps = L + 3 * S;
  for (int t = 0; t < nsteps; ++t) {
    bool any = false;
    if (t < n0) {  // level 0: mask, canonicalise, write the interior's input through
      float* l0 = lev + (t & 3) * plane0;
      const bool x_out = t >= S && t < S + L;
      const int64_t xo = (int64_t)(xb + t) * nyz;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (row0 + j >= EY) break;
        const float v = in_w[j] > 0.0f ? __fadd_rn(in_s[j], 0.0f) : nan;
        l0[(row0 + j) * EZ + col] = v;
        any |= v == v;
        if (x_out && ((out_rows >> j) & 1u)) {
          out_sdf[xo + goff[j]] = in_s[j];
          out_weight[xo + goff[j]] = in_w[j];
        }
      }
      if (t + 1 < n0) load(t + 1);
    }
    live = (live << 1) | (uint64_t)__any_sync(full, any);
    // levels from the top down: level s reads level s - 1's `took` bits of
    // plane r before level s - 1 overwrites them with plane r + 2
    for (int s = S; s >= 1; --s) {
      const int r = t - 2 * s;  // level s's plane at this step
      if (r < s || r >= n0 - s) continue;
      const int rows = EY - 2 * s;
      float* cur = lev + 4 * EZ * (s * EY - s * (s - 1)) + (r & 3) * rows * EZ;
      if (!((live >> (2 * s)) & 1u)) {  // no valid point of this warp's: its values are NaN
        const unsigned nbit = 1u << (4 * s + (r & 3));
        if (s < S && !(nan_slots & nbit)) {
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (col >= s && col < EZ - s && row0 + j >= s && row0 + j < EY - s) cur[(row0 + j - s) * EZ + col] = nan;
          nan_slots |= nbit;
        }
        continue;  // its `took` bits are never read: level s + 1 skips plane r too
      }
      nan_slots &= ~(1u << (4 * s + (r & 3)));
      const int rows_prev = rows + 2;
      const float* prev = lev + 4 * EZ * ((s - 1) * EY - (s - 1) * (s - 2));
      const float* const pl[3] = {prev + ((r - 1) & 3) * rows_prev * EZ, prev + (r & 3) * rows_prev * EZ,
                                  prev + ((r + 1) & 3) * rows_prev * EZ};
      const int colc = min(max(col, 1), EZ - 2);
      int row[V + 2];  // level s-1 offsets of rows row0 - 1 .. row0 + V (clamped into the level)
#pragma unroll
      for (int k = 0; k < V + 2; ++k) row[k] = min(max(row0 + k - s, 0), rows_prev - 1) * EZ;
      bool act[V];
      float own[V], res[V];
      bool any_own = false, all_pos = true, all_neg = true;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        act[j] = col >= s && col < EZ - s && row0 + j >= s && row0 + j < EY - s;
        own[j] = act[j] ? pl[1][row[j + 1] + colc] : nan;
        res[j] = own[j];
        if (own[j] == own[j]) {
          any_own = true;
          if (own[j] >= 0.0f) all_neg = false;
          else all_pos = false;
        }
      }
      unsigned took_now = (unsigned)(took >> ((2 * (s - 1) + (r & 1)) * V)) & vmask;
      if (__any_sync(full, any_own)) {
        float best[V];
        if (__all_sync(full, all_pos)) {
          least_candidates<false>(pl, row, colc, d, best);
        } else if (__all_sync(full, all_neg)) {
          least_candidates<true>(pl, row, colc, d, best);
        } else {
          float best_neg[V];
          least_candidates<false>(pl, row, colc, d, best);
          least_candidates<true>(pl, row, colc, d, best_neg);
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (!(own[j] >= 0.0f)) best[j] = best_neg[j];
        }
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (best[j] < fabsf(own[j])) {
            res[j] = own[j] >= 0.0f ? best[j] : -best[j];
            took_now |= 1u << j;
          }
      }
      if (s < S) {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (act[j]) cur[(row0 + j - s) * EZ + col] = res[j];
        const int fpos = (2 * s + (r & 1)) * V;
        took = (took & ~((uint64_t)vmask << fpos)) | ((uint64_t)took_now << fpos);
      } else {
        const int64_t xo = (int64_t)(xb + r) * nyz;
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (act[j] && ((out_rows >> j) & 1u) && ((took_now >> j) & 1u)) {
            out_sdf[xo + goff[j]] = res[j];
            out_weight[xo + goff[j]] = 1.0f;
          }
      }
    }
    __syncthreads();
  }
}

// shared-memory bytes of a launch (as `smem_bytes` in ops/distance_transform.py)
size_t smem_bytes(int S, int TY, int EZ) {
  const size_t EY = TY + 2 * S;
  return 4 * (4 * EZ * (S * EY - S * (S - 1)));
}

int launch(const float* sdf, const float* weight, float* out_sdf, float* out_weight, int nx, int ny, int nz,
           int S, int TY, int EZ, int seg, const float* d, cudaStream_t stream) {
  const int smem = (int)smem_bytes(S, TY, EZ);
  // per launch: the attribute belongs to the current device's context
  const cudaError_t err = cudaFuncSetAttribute(fused_sweeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int TZ = EZ - 2 * S, EY = TY + 2 * S;
  const dim3 grid((unsigned)((nz + TZ - 1) / TZ), (unsigned)((ny + TY - 1) / TY), (unsigned)((nx + seg - 1) / seg));
  const int threads = 32 * (EZ / 32) * ((EY + V - 1) / V);
  fused_sweeps_kernel<<<grid, threads, smem, stream>>>(sdf, weight, out_sdf, out_weight, nx, ny, nz, S, TY, EZ,
                                                          seg, d[0], d[1], d[2]);
  return (int)cudaGetLastError();
}

}  // namespace

// The launches of one call: launch i fuses sweeps[i] sweeps, reads the
// previous launch's output (the first reads (sdf, weight)) and writes
// (out_sdf, out_weight) if it is the last, else it alternates with
// (tmp_sdf, tmp_weight), so no launch writes what it reads; all on `stream`.
// `tile_y` interior rows and `cols` level-0 columns (a multiple of 32,
// interior cols - 2 * sweeps[i]) a block, `seg` planes of x a block, so
// cols / 32 x ceil((tile_y + 2 * sweeps[i]) / V) warps. `sweeps` and `steps` (the face, edge and corner step lengths, >= 0)
// are host arrays. Returns cudaErrorInvalidValue, launching nothing, for
// arguments the kernel does not take, else cudaGetLastError() after the
// first launch that failed, or 0 when every launch was accepted.
extern "C" int i3d_correct_sdf_dense(const void* sdf, const void* weight, void* out_sdf, void* out_weight,
                                     void* tmp_sdf, void* tmp_weight, int nx, int ny, int nz, int nlaunch,
                                     const int* sweeps, int tile_y, int cols, int seg, const float* steps,
                                     void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return (int)cudaSuccess;
  if (tile_y < 1 || seg < 1 || cols < 32 || cols % 32 != 0 || (int64_t)ny * nz > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nlaunch; ++i) {
    // S <= 8: the `took` bits of levels below S fit 64 bits, the NaN-slot bits 32
    const int S = sweeps[i];
    if (S < 1 || S > 8 || cols - 2 * S < 1 || (cols / 32) * ((tile_y + 2 * S + V - 1) / V) * 32 > kMaxThreads ||
        smem_bytes(S, tile_y, cols) > 232448)
      return (int)cudaErrorInvalidValue;
  }
  const float* src_s = (const float*)sdf;
  const float* src_w = (const float*)weight;
  const cudaStream_t st = (cudaStream_t)stream;
  for (int i = 0; i < nlaunch; ++i) {
    const bool last = (nlaunch - 1 - i) % 2 == 0;
    float* dst_s = (float*)(last ? out_sdf : tmp_sdf);
    float* dst_w = (float*)(last ? out_weight : tmp_weight);
    const int err = launch(src_s, src_w, dst_s, dst_w, nx, ny, nz, sweeps[i], tile_y, cols, seg, steps, st);
    if (err != 0) return err;
    src_s = dst_s;
    src_w = dst_w;
  }
  return (int)cudaSuccess;
}
