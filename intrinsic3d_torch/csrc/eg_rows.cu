// The E_g element pass of the level solve: per (frame, slot or bucket slot)
// element the weighted shading-gradient residual and, in the linearization
// mode, its 29 Jacobian coefficients (10 sdf, 4 albedo, 6 pose, 4
// intrinsics, 5 distortion), in one launch over a chunk of frame rows.
//
// Replaces, on the card, the eager forward of refine/residuals.py::eg_core
// over the dense element grid and the autograd reverse pass over it
// (blockform._eg_reverse): about 1,400 elementwise launches a linearized
// chunk and 500 a trial cost, each reading and writing element-grid-sized
// tensors. The JAX package has no kernel of its own for this pass (XLA
// fuses its jnp forward and reverse); the bicubic taps go through the
// Catmull-Rom functions of catrom.cuh, the ones K1a and K1b use.
//
// The element, after its flag (eg_w > 0; a bucketed row's pad block counts
// as inactive). An inactive element writes 0 to every output and reads
// nothing more. An active one reads its 10 sdf and 4 albedo stencil values
// from the shifted stacks (sdf_plan.apply, alb_plan.apply: any plane and
// block strides, unit lane stride), its 9 SH values and voxel position, and
// its frame's pose, the intrinsics, the distortion, lam[0], pyr_scale and
// voxel_size through device pointers (no host read, no upload); computes
// the four stencil points' normals, angle-axis transforms and distorted
// projections as eg_core does (the z > 1e-6 guard, the +-10 clamp, 3 radial
// and 2 tangential coefficients, the bicubic support test); an invalid
// element stops there with zeros, as eg_core's `where(valid, r, 0)` and its
// zero gradient. A valid one samples its four sites, forms
// shading_gradient_difference and scales by sqrt(w * lam[0]).
//
// Linearization mode (LIN): r0 in float32 and the 29 coefficients in the
// coefficient type (float32 or bfloat16, round to nearest even as
// Tensor.to), written straight into the [C, K, kb, B^3] fields at the
// chunk's first frame. The coefficients are a reverse pass written out per
// element: the residual's cotangent sqrt(w * lam[0]) back through the
// shading difference to the four sites' luminances and shadings, then each
// point's chain from its sampler derivatives (K1b's, masked on the
// unclipped coordinates) and its shading to the parameters, the geometry
// recomputed from registers rather than kept. It differentiates the
// formulas as eg_core writes them, with autograd's conventions: the
// clamp's gradient passes at its limits, sqrt(|d|^2 + 1e-12) and the
// normal's sqrt(|g|^2 + 1e-24) differentiate as written, the small-angle
// branch of rotate_angle_axis below theta^2 = 1e-12 (its C = 1 - theta^2 B
// through the selected B). At theta = 0 exactly autograd's unselected branch
// gives NaN (0/0); this pass gives the selected branch's derivative.
//
// Value mode: the weighted residual and, per 256-thread block, the sum of
// its elements' r^2 (a fixed order: warp shuffles, then the eight warps),
// for the LM acceptance's E_g cost.
//
// Bound on the H100: memory traffic on the main path's inputs, where 0.1-7%
// of the dense elements are active and the rest stream a flag in and zeros
// out: 4 B in and 4 + 29 x (2 or 4) B out an inactive element in the
// linearization, 8 B in value mode. The active elements' ~80 stencil and
// parameter reads and 64 taps hit L2; their ~900 float operations are far
// below the card's rate. The stream (rows_common.cuh, 4 elements a thread)
// loads the flags as one vector and writes an all-inactive group's zeros as
// one vector store per output plane; a partly active group takes its
// elements one at a time.

#include <cuda_bf16.h>

#include "catrom.cuh"
#include "rows_common.cuh"

namespace {

// a per-slot stack: plane i, block b, lane s at p[i * plane + b * blk + s]
struct Stack {
  const float* p;
  int64_t plane, blk;
};

struct EgParams {
  Stack sdf, alb, sh;   // the shifted sdf (10 planes read) and albedo (4), the per-slot SH (9)
  const int32_t* vpos;  // [3, nb*B^3] voxel coordinates
  int64_t vplane;
  const int64_t* bmap;  // [K, kb] frame buckets (pad = nb), or nullptr (dense: block j of row k is j)
  const float* poses;   // [K, 6]
  const float* intr;    // [4]
  const float* dist;    // [5]
  const float* lam;     // [4]; lam[0] is E_g's
  const float* pyr_scale;
  const float* voxel_size;
  const float* images;  // [K, H, W]
  int h, w;
  int nb, kb, s;  // the pad block, the blocks of a frame row, the lanes of a block
  int lo;         // the chunk's first frame
  void* coeff[5];   // LIN: the sdf, albedo, pose, intrinsics and distortion fields at the chunk's first element
  int64_t cstride;  // elements between two planes of a coefficient field
  float* partial;   // value mode: one r^2 sum a block
};

// the 4 normal stencils inside the 10-value sdf stencil (residuals._N4):
// entry i of point k in nibble 4k + i
__device__ __forceinline__ constexpr int n4(int k, int i) {
  return (int)((0x5384327187964160ull >> (4 * (4 * k + i))) & 15ull);
}

template <class CT>
__device__ __forceinline__ void put(void* base, int64_t i, float x) {
  if constexpr (sizeof(CT) == 2)
    reinterpret_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
  else
    reinterpret_cast<float*>(base)[i] = x;
}

// coefficient plane q (0..28) of the fields {sdf 10, albedo 4, pose 6,
// intrinsics 4, distortion 5}: its field and the plane inside it
__device__ __forceinline__ constexpr int field_of(int q) { return q < 10 ? 0 : q < 14 ? 1 : q < 20 ? 2 : q < 24 ? 3 : 4; }
__device__ __forceinline__ constexpr int first_of(int f) { return f == 0 ? 0 : f == 1 ? 10 : f == 2 ? 14 : f == 3 ? 20 : 24; }

template <class CT>
__device__ __forceinline__ void put_plane(const EgParams& p, int q, int64_t e, float x) {
  const int f = field_of(q);
  put<CT>(p.coeff[f], (int64_t)(q - first_of(f)) * p.cstride + e, x);
}

// The weighted residual of active element e (weight wgt) and, with LIN, its
// 29 coefficients in c (left 0 where the element is invalid)
template <bool LIN>
__device__ __forceinline__ float eg_element(const EgParams& p, int64_t e, float wgt, float (&c)[29]) {
  const int64_t row = (int64_t)p.kb * p.s;
  const int64_t r = e / row;
  const int64_t rem = e - r * row;
  const int j = (int)(rem / p.s);
  const int lane = (int)(rem - (int64_t)j * p.s);
  const int k = p.lo + (int)r;
  int64_t b = j;
  if (p.bmap != nullptr) {
    b = __ldg(p.bmap + (int64_t)k * p.kb + j);
    if (b < 0 || b >= p.nb) return 0.0f;
  }
  float sdf[10], alb[4], shc[9], vp[3];
#pragma unroll
  for (int i = 0; i < 10; ++i) sdf[i] = __ldg(p.sdf.p + i * p.sdf.plane + b * p.sdf.blk + lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) alb[i] = __ldg(p.alb.p + i * p.alb.plane + b * p.alb.blk + lane);
#pragma unroll
  for (int i = 0; i < 9; ++i) shc[i] = __ldg(p.sh.p + i * p.sh.plane + b * p.sh.blk + lane);
#pragma unroll
  for (int i = 0; i < 3; ++i) vp[i] = (float)__ldg(p.vpos + i * p.vplane + b * p.s + lane);
  float aa[3], t[3], d[5];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    aa[i] = __ldg(p.poses + 6 * k + i);
    t[i] = __ldg(p.poses + 6 * k + 3 + i);
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) d[i] = __ldg(p.dist + i);
  const float pyr = __ldg(p.pyr_scale);
  const float vs = __ldg(p.voxel_size);
  const float fx = __ldg(p.intr) * pyr, fy = __ldg(p.intr + 1) * pyr;
  const float cx = __ldg(p.intr + 2) * pyr, cy = __ldg(p.intr + 3) * pyr;
  const float sq = sqrtf(wgt * __ldg(p.lam));
  const float umax = (float)(p.w - 2), vmax = (float)(p.h - 2);

  // rotate_angle_axis' coefficients: R p = p C + (aa x p) A + aa (aa.p) B
  const float theta2 = aa[0] * aa[0] + aa[1] * aa[1] + aa[2] * aa[2];
  const float theta = sqrtf(theta2 + 1e-32f);
  const bool small = theta2 < 1e-12f;
  float sin_t, cos_t;
  sincosf(theta, &sin_t, &cos_t);
  const float A = small ? 1.0f - theta2 / 6.0f : sin_t / theta;
  const float B = small ? 0.5f - theta2 / 24.0f : (1.0f - cos_t) / theta2;
  const float C = small ? 1.0f - theta2 * B : cos_t;

  // one stencil point: its normal n (from the unnormalized gradient g and
  // its norm), iso-surface point pw, camera point pc, normalized and
  // distorted coordinates
  struct Point {
    float g[3], nrm, n[3], pw[3], cr[3], dot, z, q[2], xn, yn, r2, r4, r6, rad, xd, yd;
  };
  auto point = [&](const int kk, Point& o) {
    const float s0 = sdf[n4(kk, 0)];
#pragma unroll
    for (int a = 0; a < 3; ++a) o.g[a] = sdf[n4(kk, a + 1)] - s0;
    o.nrm = sqrtf(o.g[0] * o.g[0] + o.g[1] * o.g[1] + o.g[2] * o.g[2] + 1e-24f);
#pragma unroll
    for (int a = 0; a < 3; ++a) o.n[a] = o.g[a] / o.nrm;
#pragma unroll
    for (int a = 0; a < 3; ++a) o.pw[a] = (vp[a] + (kk == a + 1 ? 1.0f : 0.0f)) * vs - o.n[a] * s0;
    o.cr[0] = aa[1] * o.pw[2] - aa[2] * o.pw[1];
    o.cr[1] = aa[2] * o.pw[0] - aa[0] * o.pw[2];
    o.cr[2] = aa[0] * o.pw[1] - aa[1] * o.pw[0];
    o.dot = o.pw[0] * aa[0] + o.pw[1] * aa[1] + o.pw[2] * aa[2];
    float pc[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) pc[a] = o.pw[a] * C + o.cr[a] * A + aa[a] * o.dot * B + t[a];
    o.z = pc[2];
    const float zs = o.z > 1e-6f ? o.z : 1.0f;
    o.q[0] = pc[0] / zs;
    o.q[1] = pc[1] / zs;
    o.xn = fminf(fmaxf(o.q[0], -10.0f), 10.0f);
    o.yn = fminf(fmaxf(o.q[1], -10.0f), 10.0f);
    o.r2 = o.xn * o.xn + o.yn * o.yn;
    o.r4 = o.r2 * o.r2;
    o.r6 = o.r4 * o.r2;
    o.rad = 1.0f + d[0] * o.r2 + d[1] * o.r4 + d[2] * o.r6;
    o.xd = o.xn * o.rad + 2.0f * d[3] * o.xn * o.yn + d[4] * (o.r2 + 2.0f * o.xn * o.xn);
    o.yd = o.yn * o.rad + 2.0f * d[4] * o.xn * o.yn + d[3] * (o.r2 + 2.0f * o.yn * o.yn);
  };

  // pass 1: the four projections and the validity test, then the samples
  // and the shadings
  float u[4], v[4], nv[4][3];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    Point o;
    point(kk, o);
    u[kk] = fx * o.xd + cx;
    v[kk] = fy * o.yd + cy;
    if (!(o.z > 1e-6f && u[kk] >= 1.0f && u[kk] < umax && v[kk] >= 1.0f && v[kk] < vmax)) return 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) nv[kk][a] = o.n[a];
  }
  const float xmax = i3d_catrom::clip_max(p.w), ymax = i3d_catrom::clip_max(p.h);
  float lum[4], ix[4], iy[4], shd[4], shade[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (LIN) {
      float tp[16], wx[4], wy[4], dwx[4], dwy[4];
      i3d_catrom::taps(p.images, p.h, p.w, xmax, ymax, (uint32_t)k, u[kk], v[kk], tp, wx, wy, dwx, dwy);
      i3d_catrom::sums(tp, wx, wy, dwx, dwy, u[kk], v[kk], xmax, ymax, lum[kk], ix[kk], iy[kk]);
    } else {
      lum[kk] = i3d_catrom::value(p.images, p.h, p.w, xmax, ymax, (uint32_t)k, u[kk], v[kk]);
    }
    const float nx = nv[kk][0], ny = nv[kk][1], nz = nv[kk][2];
    shd[kk] = shc[0] + shc[1] * ny + shc[2] * nz + shc[3] * nx + shc[4] * (nx * ny) + shc[5] * (ny * nz) +
              shc[6] * (-nx * nx - ny * ny + 2.0f * nz * nz) + shc[7] * (nx * nz) + shc[8] * (nx * nx - ny * ny);
    shade[kk] = alb[kk] * shd[kk];
  }
  float dd[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) dd[i] = (shade[i + 1] - shade[0]) - (lum[i + 1] - lum[0]);
  const float res = sqrtf(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2] + 1e-12f);
  if constexpr (!LIN) {
    return sq * res;
  } else {
    // pass 2: the cotangent sq of the residual back to every parameter
    float g_shade[4], g_lum[4];
    float gsum = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float gd = sq * dd[i] / res;
      g_shade[i + 1] = gd;
      g_lum[i + 1] = -gd;
      gsum += gd;
    }
    g_shade[0] = -gsum;
    g_lum[0] = gsum;
    float gA = 0.0f, gB = 0.0f, gC = 0.0f, gfx = 0.0f, gfy = 0.0f, gcx = 0.0f, gcy = 0.0f;
    float gaa[3] = {0.0f, 0.0f, 0.0f}, gt[3] = {0.0f, 0.0f, 0.0f}, gd5[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Point o;
      point(kk, o);
      // u = fx xd + cx, v = fy yd + cy through the sampler's derivatives
      const float gu = g_lum[kk] * ix[kk], gv = g_lum[kk] * iy[kk];
      gfx += gu * o.xd;
      gcx += gu;
      gfy += gv * o.yd;
      gcy += gv;
      const float gxd = gu * fx, gyd = gv * fy;
      // the distortion
      const float grad = gxd * o.xn + gyd * o.yn;
      gd5[0] += grad * o.r2;
      gd5[1] += grad * o.r4;
      gd5[2] += grad * o.r6;
      gd5[3] += gxd * (2.0f * o.xn * o.yn) + gyd * (o.r2 + 2.0f * o.yn * o.yn);
      gd5[4] += gxd * (o.r2 + 2.0f * o.xn * o.xn) + gyd * (2.0f * o.xn * o.yn);
      const float gr2 = grad * (d[0] + 2.0f * d[1] * o.r2 + 3.0f * d[2] * o.r4) + gxd * d[4] + gyd * d[3];
      const float gxn =
          gxd * (o.rad + 2.0f * d[3] * o.yn + 4.0f * d[4] * o.xn) + gyd * (2.0f * d[4] * o.yn) + 2.0f * o.xn * gr2;
      const float gyn =
          gyd * (o.rad + 2.0f * d[4] * o.xn + 4.0f * d[3] * o.yn) + gxd * (2.0f * d[3] * o.xn) + 2.0f * o.yn * gr2;
      // the clamp passes its gradient at the limits themselves
      const float gqx = (o.q[0] >= -10.0f && o.q[0] <= 10.0f) ? gxn : 0.0f;
      const float gqy = (o.q[1] >= -10.0f && o.q[1] <= 10.0f) ? gyn : 0.0f;
      const float gpc[3] = {gqx / o.z, gqy / o.z, -(gqx * o.q[0] + gqy * o.q[1]) / o.z};
      // pc = pw C + cr A + aa dot B + t, cr = aa x pw, dot = pw . aa
      float gpw[3], gcr[3];
      float gdot = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        gt[a] += gpc[a];
        gC += gpc[a] * o.pw[a];
        gA += gpc[a] * o.cr[a];
        gB += gpc[a] * aa[a] * o.dot;
        gpw[a] = gpc[a] * C;
        gcr[a] = gpc[a] * A;
        gaa[a] += gpc[a] * B * o.dot;
        gdot += gpc[a] * B * aa[a];
      }
      gpw[0] += gcr[1] * aa[2] - gcr[2] * aa[1];
      gpw[1] += gcr[2] * aa[0] - gcr[0] * aa[2];
      gpw[2] += gcr[0] * aa[1] - gcr[1] * aa[0];
      gaa[0] += o.pw[1] * gcr[2] - o.pw[2] * gcr[1];
      gaa[1] += o.pw[2] * gcr[0] - o.pw[0] * gcr[2];
      gaa[2] += o.pw[0] * gcr[1] - o.pw[1] * gcr[0];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        gpw[a] += gdot * aa[a];
        gaa[a] += gdot * o.pw[a];
      }
      // pw = (vpos + offset) voxel_size - n s0
      const float s0 = sdf[n4(kk, 0)];
      float gn[3];
      float gs0 = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        gn[a] = -s0 * gpw[a];
        gs0 -= gpw[a] * o.n[a];
      }
      // shade = albedo (sh . basis(n))
      c[10 + kk] = g_shade[kk] * shd[kk];
      const float gb = g_shade[kk] * alb[kk];
      const float nx = o.n[0], ny = o.n[1], nz = o.n[2];
      gn[0] += gb * (shc[3] + shc[4] * ny - 2.0f * shc[6] * nx + shc[7] * nz + 2.0f * shc[8] * nx);
      gn[1] += gb * (shc[1] + shc[4] * nx + shc[5] * nz - 2.0f * shc[6] * ny - 2.0f * shc[8] * ny);
      gn[2] += gb * (shc[2] + shc[5] * ny + 4.0f * shc[6] * nz + shc[7] * nx);
      // n = g / sqrt(|g|^2 + 1e-24), g = (s1 - s0, s2 - s0, s3 - s0)
      const float ndot = gn[0] * nx + gn[1] * ny + gn[2] * nz;
      float gsum_g = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float gg = (gn[a] - o.n[a] * ndot) / o.nrm;
        c[n4(kk, a + 1)] += gg;
        gsum_g += gg;
      }
      c[n4(kk, 0)] += gs0 - gsum_g;
    }
    // the angle-axis coefficients' chain to theta^2, then to aa
    float gth2;
    if (small) {
      const float gB2 = gB - gC * theta2;
      gth2 = -gA / 6.0f - gB2 / 24.0f - gC * B;
    } else {
      const float g_cos = gC - gB / theta2;
      const float gth = gA / theta * cos_t - gA * sin_t / (theta * theta) - g_cos * sin_t;
      gth2 = -gB * (1.0f - cos_t) / (theta2 * theta2) + gth * 0.5f / theta;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      c[14 + a] = gaa[a] + 2.0f * aa[a] * gth2;
      c[17 + a] = gt[a];
    }
    c[20] = gfx * pyr;
    c[21] = gfy * pyr;
    c[22] = gcx * pyr;
    c[23] = gcy * pyr;
#pragma unroll
    for (int i = 0; i < 5; ++i) c[24 + i] = gd5[i];
    return sq * res;
  }
}

template <bool LIN, class CT>
struct EgOp {
  static constexpr int NOUT = 1;  // the weighted residual
  static constexpr bool OWN_IO = true;
  using Params = EgParams;

  // one element: its residual (and coefficients) or zeros
  __device__ static __forceinline__ void one(const Params& p, const i3d_rows::Arrays<1>& a, int64_t e, float wgt,
                                             float& acc) {
    float c[29];
#pragma unroll
    for (int q = 0; q < 29; ++q) c[q] = 0.0f;
    const float res = wgt > 0.0f ? eg_element<LIN>(p, e, wgt, c) : 0.0f;
    a.out[0][e] = res;
    if constexpr (LIN) {
#pragma unroll
      for (int q = 0; q < 29; ++q) put_plane<CT>(p, q, e, c[q]);
    } else {
      acc = fmaf(res, res, acc);
    }
  }

  template <int V, bool VEC>
  __device__ static __forceinline__ void group(const Params& p, const i3d_rows::Arrays<1>& a, int64_t e0,
                                               const float (&act)[V], bool any, float& acc) {
    if (!any) {
      float z[V];
#pragma unroll
      for (int i = 0; i < V; ++i) z[i] = 0.0f;
      i3d_rows::store_f<V, VEC>(a.out[0] + e0, z);
      if constexpr (LIN) {
#pragma unroll
        for (int q = 0; q < 29; ++q) {
          const int f = field_of(q);
          const int64_t at = (int64_t)(q - first_of(f)) * p.cstride + e0;
          if constexpr (VEC && sizeof(CT) == 4) {
            i3d_rows::store_f<V, true>(reinterpret_cast<float*>(p.coeff[f]) + at, z);
          } else if constexpr (VEC && V == 4) {
            *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(p.coeff[f]) + at) = make_uint2(0u, 0u);
          } else {
#pragma unroll
            for (int i = 0; i < V; ++i) put<CT>(p.coeff[f], at + i, 0.0f);
          }
        }
      }
      return;
    }
    // a partly active group, one element at a time (not unrolled: one copy
    // of the element's code)
#pragma unroll 1
    for (int v = 0; v < V; ++v) {
      float wgt = 0.0f;
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (i == v) wgt = act[i];
      one(p, a, e0 + v, wgt, acc);
    }
  }

  // value mode: the block's r^2 sum, warps first, in a fixed order
  __device__ static __forceinline__ void block_end(const Params& p, float acc) {
    if constexpr (!LIN) {
      __shared__ float warp_sums[8];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
      if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
      __syncthreads();
      if (threadIdx.x == 0) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s += warp_sums[i];
        p.partial[blockIdx.x] = s;
      }
    }
  }
};

constexpr int V = 4;
constexpr int THREADS = 256;

template <bool LIN, class CT>
int launch(const EgParams& p, const i3d_rows::Arrays<1>& a, cudaStream_t stream) {
  const int64_t ngroups = a.m / V;
  const unsigned int blocks = (unsigned int)((ngroups + 1 + THREADS - 1) / THREADS);
  // whole groups take vector loads and stores where every array's first
  // element is aligned to one group's bytes, and so is every plane's
  bool vec = i3d_rows::aligned16(a.active) && i3d_rows::aligned16(a.out[0]);
  if constexpr (LIN) {
    vec = vec && p.cstride % V == 0;
    for (int f = 0; f < 5; ++f) vec = vec && ((uintptr_t)p.coeff[f] & (V * sizeof(CT) - 1)) == 0;
  }
  if (vec)
    i3d_rows::rows_vec_kernel<EgOp<LIN, CT>, V, true><<<blocks, THREADS, 0, stream>>>(p, a, ngroups);
  else
    i3d_rows::rows_vec_kernel<EgOp<LIN, CT>, V, false><<<blocks, THREADS, 0, stream>>>(p, a, ngroups);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of blocks (value mode: of partial sums) a launch over m
// elements takes.
extern "C" long long i3d_eg_rows_blocks(long long m) { return (m / V + 1 + THREADS - 1) / THREADS; }

// One chunk of the E_g pass over the m elements of frame rows [lo, lo + m /
// (kb * s)), launched on `stream`; returns cudaGetLastError() (0 =
// launched). mode 0: value (r_out and partial); 1: linearization with
// float32 coefficients; 2: with bfloat16 coefficients (coeff[5], cstride).
// Strides are in elements.
extern "C" int i3d_eg_rows(const void* eg_w, long long m, int mode,
                           const void* sdf, long long sdf_plane, long long sdf_blk,
                           const void* alb, long long alb_plane, long long alb_blk,
                           const void* sh, long long sh_plane, long long sh_blk,
                           const void* vpos, long long vplane, const void* bmap,
                           const void* poses, const void* intr, const void* dist, const void* lam,
                           const void* pyr_scale, const void* voxel_size, const void* images, int h, int w,
                           int nb, int kb, int s, int lo, void* r_out, void* c_sdf, void* c_alb, void* c_pose,
                           void* c_intr, void* c_dist, long long cstride, void* partial, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  EgParams p;
  p.sdf = {(const float*)sdf, sdf_plane, sdf_blk};
  p.alb = {(const float*)alb, alb_plane, alb_blk};
  p.sh = {(const float*)sh, sh_plane, sh_blk};
  p.vpos = (const int32_t*)vpos;
  p.vplane = vplane;
  p.bmap = (const int64_t*)bmap;
  p.poses = (const float*)poses;
  p.intr = (const float*)intr;
  p.dist = (const float*)dist;
  p.lam = (const float*)lam;
  p.pyr_scale = (const float*)pyr_scale;
  p.voxel_size = (const float*)voxel_size;
  p.images = (const float*)images;
  p.h = h;
  p.w = w;
  p.nb = nb;
  p.kb = kb;
  p.s = s;
  p.lo = lo;
  void* fields[5] = {c_sdf, c_alb, c_pose, c_intr, c_dist};
  for (int f = 0; f < 5; ++f) p.coeff[f] = fields[f];
  p.cstride = cstride;
  p.partial = (float*)partial;
  const i3d_rows::Arrays<1> a{(const float*)eg_w, nullptr, nullptr, nullptr, {(float*)r_out}, (int64_t)m};
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) return launch<false, float>(p, a, st);
  if (mode == 1) return launch<true, float>(p, a, st);
  return launch<true, __nv_bfloat16>(p, a, st);
}
