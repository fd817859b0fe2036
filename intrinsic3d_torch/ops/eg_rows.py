"""The E_g element pass of the level solve: CUDA kernel and plain version.

Each (frame, slot or bucket slot) element of the block-dense layout
(`refine.blockform.BlockAssembly`) has the weighted shading-gradient
residual of `refine.residuals.eg_core` and 29 Jacobian coefficients {10 sdf,
4 albedo, 6 pose, 4 intrinsics, 5 distortion}. On the card one launch of
`csrc/eg_rows.cu` a chunk of frame rows computes them in place of the eager
forward over the element grid and its autograd reverse pass:

- `eg_rows_lin` writes the residual (float32) and the coefficients (float32
  or bfloat16) straight into the `[K, kb, B³]` residual and `[C, K, kb, B³]`
  coefficient fields at the chunk's first frame;
- `eg_rows_value` returns the residual and per-block partial sums of r²
  (the LM acceptance's E_g cost is their sum).

The inputs are read where the block solve keeps them (`EgRowsInputs`): the
shifted sdf and albedo stacks, the per-slot SH and voxel positions, the frame
buckets, and the poses, intrinsics, distortion, λ̃, pyramid scale and voxel
size as device tensors, so a launch reads nothing back to the host.

On CPU tensors the wrappers run `eg_rows_plain`, the plain per-element
version in the same flat element layout, which the CPU tests hold to the
eager forward and its autograd and the card's tests hold the kernel to. The
level solve itself takes the eager path on the CPU (`refine/blockform.py`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from intrinsic3d_torch.ops import build
from intrinsic3d_torch.ops.bicubic import bicubic_rows_plain
from intrinsic3d_torch.ops.build import LAUNCHES

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int

# elements a thread and threads a block of the kernel: a value-mode launch
# over m elements writes `partial_blocks(m)` partial sums
_V, _THREADS = 4, 256

# the four normal stencils inside the 10-value sdf stencil (residuals._N4)
_N4 = ((0, 6, 1, 4), (6, 9, 7, 8), (1, 7, 2, 3), (4, 8, 3, 5))
# the coefficient fields' plane counts: sdf, albedo, pose, intrinsics, distortion
FIELDS = (10, 4, 6, 4, 5)


class EgRowsInputs(NamedTuple):
    """What every chunk of one E_g pass reads, all on one device."""

    sdf: torch.Tensor  # [T ≥ 10, nb, B³] shifted sdf stack (sdf_plan.apply)
    alb: torch.Tensor  # [T ≥ 4, nb, B³] shifted albedo stack
    sh: torch.Tensor  # [9, nb·B³] per-slot SH coefficients
    vpos: torch.Tensor  # [3, nb·B³] int32 voxel coordinates
    bmap: Optional[torch.Tensor]  # [K, kb] int64 frame buckets (pad = nb), or None (dense)
    poses: torch.Tensor  # [K, 6]
    intr: torch.Tensor  # [4]
    dist: torch.Tensor  # [5]
    lam: torch.Tensor  # [4] normalized λ̃; E_g's is lam[0]
    pyr_scale: torch.Tensor  # scalar
    voxel_size: torch.Tensor  # scalar
    images: torch.Tensor  # [K, H, W] float32


def partial_blocks(m: int) -> int:
    """The partial sums a value-mode pass over `m` elements writes: block b
    sums the elements [1024·b, 1024·(b+1))."""
    return (m // _V + 1 + _THREADS - 1) // _THREADS


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def eg_rows_plain(x: EgRowsInputs, eg_w: torch.Tensor, lo: int, lin: bool):
    """The pass over the frame rows `[lo, lo + n)` with weights `eg_w [n, kb,
    B³]`, element for element what the kernel computes, flat: the weighted
    residual `[m]` (m = n·kb·B³) and, with `lin`, the 29 coefficient rows
    `[29, m]` (float32; else None). Inactive elements (weight 0 or a pad
    bucket row) and invalid ones (a point at z ≤ 1e-6 or outside the bicubic
    support) give zeros; the coefficients are the reverse pass written out
    (`csrc/eg_rows.cu`), the numbers autograd gives through `eg_core`."""
    n, kb, s = eg_w.shape
    m = n * kb * s
    dev = eg_w.device
    e = torch.arange(m, device=dev)
    k = lo + e // (kb * s)
    j = (e // s) % kb
    lane = e % s
    wgt = eg_w.reshape(-1)
    nb = x.sdf.shape[1]
    if x.bmap is None:
        blk = j
        act = wgt > 0.0
    else:
        blk = x.bmap[k, j]
        act = (wgt > 0.0) & (blk >= 0) & (blk < nb)
        blk = torch.where(act, blk, torch.zeros_like(blk))
    slot = blk * s + lane
    sdf = x.sdf[:10, blk, lane]  # [10, m]
    alb = x.alb[:4, blk, lane]
    shc = x.sh[:, slot]
    vp = x.vpos[:, slot].to(torch.float32)
    aa = x.poses[k, :3].T  # [3, m]
    t = x.poses[k, 3:].T
    d = x.dist
    pyr, vs = x.pyr_scale, x.voxel_size
    fx, fy, cx, cy = (x.intr[i] * pyr for i in range(4))
    sq = torch.sqrt(wgt * x.lam[0])
    _, h, w = x.images.shape

    # the forward's sums over a last axis, as eg_core takes them
    def lastsum(*terms):
        return torch.sum(torch.stack(terms, dim=-1), dim=-1)

    theta2 = lastsum(*(aa * aa))
    theta = torch.sqrt(theta2 + 1e-32)
    small = theta2 < 1e-12
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    A = torch.where(small, 1.0 - theta2 / 6.0, sin_t / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos_t) / theta2)
    C = torch.where(small, 1.0 - theta2 * B, cos_t)

    def point(kk):
        s0 = sdf[_N4[kk][0]]
        g = torch.stack([sdf[_N4[kk][a + 1]] - s0 for a in range(3)])
        nrm = torch.sqrt(lastsum(*(g * g)) + 1e-24)
        nv = g / nrm
        off = torch.tensor([1.0 if kk == a + 1 else 0.0 for a in range(3)], device=dev).view(3, 1)
        pw = (vp + off) * vs - nv * s0
        # the camera point as rotate_angle_axis forms it, over a last axis
        pw_m, aa_m = pw.T, aa.T
        cr = torch.linalg.cross(aa_m, pw_m, dim=-1).T
        dot = torch.sum(pw_m * aa_m, dim=-1)
        pc = (pw_m * C[:, None] + cr.T * A[:, None] + aa_m * dot[:, None] * B[:, None]).T + t
        z = pc[2]
        zs = torch.where(z > 1e-6, z, torch.ones_like(z))
        q = pc[:2] / zs
        xn = torch.clamp(q[0], -10.0, 10.0)
        yn = torch.clamp(q[1], -10.0, 10.0)
        r2 = xn * xn + yn * yn
        r4 = r2 * r2
        r6 = r4 * r2
        rad = 1.0 + d[0] * r2 + d[1] * r4 + d[2] * r6
        xd = xn * rad + 2.0 * d[3] * xn * yn + d[4] * (r2 + 2.0 * xn * xn)
        yd = yn * rad + 2.0 * d[4] * xn * yn + d[3] * (r2 + 2.0 * yn * yn)
        return dict(s0=s0, nrm=nrm, n=nv, pw=pw, cr=cr, dot=dot, z=z, q=q, xn=xn, yn=yn, r2=r2, r4=r4, r6=r6,
                    rad=rad, xd=xd, yd=yd)

    pts = [point(kk) for kk in range(4)]
    valid = act.clone()
    lum, ix, iy, shd = [], [], [], []
    fid = k.to(torch.int32)
    for o in pts:
        u = fx * o["xd"] + cx
        v = fy * o["yd"] + cy
        valid &= (o["z"] > 1e-6) & (u >= 1.0) & (u < w - 2) & (v >= 1.0) & (v < h - 2)
        val, gx, gy = bicubic_rows_plain(x.images, fid, u, v, act.to(torch.float32))
        lum.append(val)
        ix.append(gx)
        iy.append(gy)
        nx, ny, nz = o["n"]
        basis = (torch.ones_like(nx), ny, nz, nx, nx * ny, ny * nz, -nx * nx - ny * ny + 2.0 * nz * nz, nx * nz,
                 nx * nx - ny * ny)
        # eg_core's sum over the 9 products runs in order (an outer reduction)
        acc = shc[0] * basis[0]
        for i in range(1, 9):
            acc = acc + shc[i] * basis[i]
        shd.append(acc)
    shade = [alb[kk] * shd[kk] for kk in range(4)]
    dd = [(shade[i + 1] - shade[0]) - (lum[i + 1] - lum[0]) for i in range(3)]
    res = torch.sqrt(lastsum(*(di * di for di in dd)) + 1e-12)
    zero = torch.zeros_like(res)
    r = torch.where(valid, sq * res, zero)
    if not lin:
        return r, None

    gd = [sq * dd[i] / res for i in range(3)]
    gsum = gd[0] + gd[1] + gd[2]
    g_shade = [-gsum] + gd
    g_lum = [gsum] + [-g for g in gd]
    c = [zero.clone() for _ in range(29)]
    gA = gB = gC = gfx = gfy = gcx = gcy = zero
    gaa = [zero] * 3
    gt = [zero] * 3
    gd5 = [zero] * 5
    for kk, o in enumerate(pts):
        gu, gv = g_lum[kk] * ix[kk], g_lum[kk] * iy[kk]
        gfx = gfx + gu * o["xd"]
        gcx = gcx + gu
        gfy = gfy + gv * o["yd"]
        gcy = gcy + gv
        gxd, gyd = gu * fx, gv * fy
        xn, yn, r2 = o["xn"], o["yn"], o["r2"]
        grad = gxd * xn + gyd * yn
        gd5 = [gd5[0] + grad * r2, gd5[1] + grad * o["r4"], gd5[2] + grad * o["r6"],
               gd5[3] + gxd * (2.0 * xn * yn) + gyd * (r2 + 2.0 * yn * yn),
               gd5[4] + gxd * (r2 + 2.0 * xn * xn) + gyd * (2.0 * xn * yn)]
        gr2 = grad * (d[0] + 2.0 * d[1] * r2 + 3.0 * d[2] * o["r4"]) + gxd * d[4] + gyd * d[3]
        gxn = gxd * (o["rad"] + 2.0 * d[3] * yn + 4.0 * d[4] * xn) + gyd * (2.0 * d[4] * yn) + 2.0 * xn * gr2
        gyn = gyd * (o["rad"] + 2.0 * d[4] * xn + 4.0 * d[3] * yn) + gxd * (2.0 * d[3] * xn) + 2.0 * yn * gr2
        q, z = o["q"], o["z"]
        gqx = torch.where((q[0] >= -10.0) & (q[0] <= 10.0), gxn, zero)
        gqy = torch.where((q[1] >= -10.0) & (q[1] <= 10.0), gyn, zero)
        gpc = [gqx / z, gqy / z, -(gqx * q[0] + gqy * q[1]) / z]
        pw, cr, dot = o["pw"], o["cr"], o["dot"]
        gpw, gcr, gdot = [], [], zero
        for a in range(3):
            gt[a] = gt[a] + gpc[a]
            gC = gC + gpc[a] * pw[a]
            gA = gA + gpc[a] * cr[a]
            gB = gB + gpc[a] * aa[a] * dot
            gpw.append(gpc[a] * C)
            gcr.append(gpc[a] * A)
            gaa[a] = gaa[a] + gpc[a] * B * dot
            gdot = gdot + gpc[a] * B * aa[a]
        gpw = [gpw[0] + gcr[1] * aa[2] - gcr[2] * aa[1],
               gpw[1] + gcr[2] * aa[0] - gcr[0] * aa[2],
               gpw[2] + gcr[0] * aa[1] - gcr[1] * aa[0]]
        gaa = [gaa[0] + pw[1] * gcr[2] - pw[2] * gcr[1],
               gaa[1] + pw[2] * gcr[0] - pw[0] * gcr[2],
               gaa[2] + pw[0] * gcr[1] - pw[1] * gcr[0]]
        gpw = [gpw[a] + gdot * aa[a] for a in range(3)]
        gaa = [gaa[a] + gdot * pw[a] for a in range(3)]
        s0, nv = o["s0"], o["n"]
        gn = [-s0 * gpw[a] for a in range(3)]
        gs0 = -(gpw[0] * nv[0]) - gpw[1] * nv[1] - gpw[2] * nv[2]
        c[10 + kk] = g_shade[kk] * shd[kk]
        gb = g_shade[kk] * alb[kk]
        nx, ny, nz = nv
        gn[0] = gn[0] + gb * (shc[3] + shc[4] * ny - 2.0 * shc[6] * nx + shc[7] * nz + 2.0 * shc[8] * nx)
        gn[1] = gn[1] + gb * (shc[1] + shc[4] * nx + shc[5] * nz - 2.0 * shc[6] * ny - 2.0 * shc[8] * ny)
        gn[2] = gn[2] + gb * (shc[2] + shc[5] * ny + 4.0 * shc[6] * nz + shc[7] * nx)
        ndot = gn[0] * nx + gn[1] * ny + gn[2] * nz
        gg = [(gn[a] - nv[a] * ndot) / o["nrm"] for a in range(3)]
        for a in range(3):
            c[_N4[kk][a + 1]] = c[_N4[kk][a + 1]] + gg[a]
        c[_N4[kk][0]] = c[_N4[kk][0]] + gs0 - (gg[0] + gg[1] + gg[2])
    gth = gA / theta * cos_t - gA * sin_t / (theta * theta) - (gC - gB / theta2) * sin_t
    gth2 = torch.where(
        small,
        -gA / 6.0 - (gB - gC * theta2) / 24.0 - gC * B,
        -gB * (1.0 - cos_t) / (theta2 * theta2) + gth * 0.5 / theta,
    )
    for a in range(3):
        c[14 + a] = gaa[a] + 2.0 * aa[a] * gth2
        c[17 + a] = gt[a]
    c[20:24] = [gfx * pyr, gfy * pyr, gcx * pyr, gcy * pyr]
    c[24:29] = gd5
    coeffs = torch.where(valid, torch.stack(c), zero)
    return r, coeffs


def _value_partials(r: torch.Tensor) -> torch.Tensor:
    """The kernel's per-block r² sums of a flat residual (plain)."""
    m = r.shape[0]
    nblk = partial_blocks(m)
    sq = torch.zeros(nblk * _V * _THREADS, dtype=r.dtype, device=r.device)
    sq[:m] = r * r
    return sq.view(nblk, -1).sum(dim=1)


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------

_SIGNATURE = (
    [_VP, _LL, _I]
    + [_VP, _LL, _LL] * 3
    + [_VP, _LL, _VP]
    + [_VP] * 7 + [_I, _I]
    + [_I] * 4
    + [_VP] * 6 + [_LL, _VP, _VP]
)


def _entry():
    fn = build.load("eg_rows").i3d_eg_rows
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return fn


def _stack(t: torch.Tensor):
    """(pointer, plane stride, block stride) of a `[T, nb, B³]` stack."""
    return t.data_ptr(), t.stride(0), t.stride(1)


def _for_kernel(x: EgRowsInputs) -> EgRowsInputs:
    """`x` as the kernel reads it: the stacks and per-slot fields with
    adjacent lanes (any plane and block strides: a rank's per-slot SH is a
    view), the per-frame and scalar tensors contiguous; a copy only where a
    tensor is not so already."""
    def lanes(t):
        return t if t.stride(-1) == 1 else t.contiguous()

    return x._replace(
        sdf=lanes(x.sdf), alb=lanes(x.alb), sh=lanes(x.sh), vpos=lanes(x.vpos),
        bmap=None if x.bmap is None else x.bmap.contiguous(), poses=x.poses.contiguous(),
        intr=x.intr.contiguous(), dist=x.dist.contiguous(), lam=x.lam.contiguous(), images=x.images.contiguous(),
    )


def _check(x: EgRowsInputs, eg_w: torch.Tensor, lo: int) -> None:
    dev = eg_w.device
    n, kb, s = eg_w.shape
    nb = x.sdf.shape[1]
    f32 = [("eg_w", eg_w), ("sdf", x.sdf), ("alb", x.alb), ("sh", x.sh), ("poses", x.poses), ("intr", x.intr),
           ("dist", x.dist), ("lam", x.lam), ("pyr_scale", x.pyr_scale), ("voxel_size", x.voxel_size),
           ("images", x.images)]
    for name, t in f32 + [("vpos", x.vpos)] + ([("bmap", x.bmap)] if x.bmap is not None else []):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, the weights on {dev}")
    for name, t in f32:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if x.vpos.dtype != torch.int32 or (x.bmap is not None and x.bmap.dtype != torch.int64):
        raise ValueError("vpos must be int32 and bmap int64")
    k = x.poses.shape[0]
    if x.sdf.shape[0] < 10 or x.alb.shape[0] < 4 or x.alb.shape[1:] != x.sdf.shape[1:] or x.sdf.shape[2] != s:
        raise ValueError(f"stacks {tuple(x.sdf.shape)}, {tuple(x.alb.shape)} do not fit weights {tuple(eg_w.shape)}")
    if tuple(x.sh.shape) != (9, nb * s) or tuple(x.vpos.shape) != (3, nb * s):
        raise ValueError(f"sh {tuple(x.sh.shape)} or vpos {tuple(x.vpos.shape)} is not per slot of {nb} blocks")
    if x.bmap is None and kb != nb:
        raise ValueError(f"dense rows of {kb} blocks for a layout of {nb}")
    if x.bmap is not None and tuple(x.bmap.shape) != (k, kb):
        raise ValueError(f"bmap {tuple(x.bmap.shape)} for {k} frames of {kb} bucket blocks")
    if not 0 <= lo or lo + n > k or x.images.shape[0] != k:
        raise ValueError(f"frame rows [{lo}, {lo + n}) outside {k} frames")


def _launch(x: EgRowsInputs, eg_w, lo: int, r_out, coeffs, cstride: int, partial) -> None:
    x = _for_kernel(x)
    n, kb, s = eg_w.shape
    m = n * kb * s
    mode = 0 if coeffs is None else (2 if coeffs[0].dtype == torch.bfloat16 else 1)
    cptr = [None] * 5 if coeffs is None else [c.data_ptr() for c in coeffs]
    _, h, w = x.images.shape
    with torch.cuda.device(eg_w.device):
        rc = _entry()(
            eg_w.data_ptr(), m, mode,
            *_stack(x.sdf), *_stack(x.alb), x.sh.data_ptr(), x.sh.stride(0), s,
            x.vpos.data_ptr(), x.vpos.stride(0), None if x.bmap is None else x.bmap.data_ptr(),
            x.poses.data_ptr(), x.intr.data_ptr(), x.dist.data_ptr(), x.lam.data_ptr(), x.pyr_scale.data_ptr(),
            x.voxel_size.data_ptr(), x.images.data_ptr(), h, w,
            x.sdf.shape[1], kb, s, lo, r_out.data_ptr(), *cptr, cstride,
            None if partial is None else partial.data_ptr(),
            torch.cuda.current_stream(eg_w.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"eg_rows kernel launch failed: CUDA error {rc}")
    LAUNCHES["eg_rows_value" if coeffs is None else "eg_rows_lin"] += 1


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------


def eg_rows_lin(x: EgRowsInputs, eg_w: torch.Tensor, lo: int, r0: torch.Tensor, coeffs) -> None:
    """Linearize the frame rows `[lo, lo + n)` (weights `eg_w [n, kb, B³]`,
    a strided view copied): their weighted residuals into `r0[lo:lo+n]`
    (float32 `[K, kb, B³]`) and their 29 coefficients into
    `coeffs[f][:, lo:lo+n]`, the five contiguous `[C, K, kb, B³]` fields
    `FIELDS` of one dtype, float32 or bfloat16. One kernel launch on CUDA
    tensors, `eg_rows_plain` on CPU tensors."""
    n = eg_w.shape[0]
    if tuple(r0.shape[1:]) != tuple(eg_w.shape[1:]) or r0.dtype != torch.float32 or not r0.is_contiguous():
        raise ValueError(f"r0 {tuple(r0.shape)} {r0.dtype} does not fit the weights {tuple(eg_w.shape)}")
    for c, f in zip(coeffs, FIELDS):
        if tuple(c.shape) != (f, *r0.shape) or c.dtype != coeffs[0].dtype or not c.is_contiguous():
            raise ValueError(f"coefficient field {tuple(c.shape)} {c.dtype} is not a contiguous [{f}, K, kb, B³]")
    if coeffs[0].dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"coefficients in {coeffs[0].dtype}: float32 or bfloat16 only")
    eg_w = eg_w.contiguous()
    _check(x, eg_w, lo)
    if eg_w.is_cuda:
        cstride = r0.numel()
        _launch(x, eg_w, lo, r0[lo:], [c[0, lo:] for c in coeffs], cstride, None)
        return
    r, cf = eg_rows_plain(x, eg_w, lo, lin=True)
    r0[lo : lo + n] = r.view(eg_w.shape)
    at = 0
    for c, f in zip(coeffs, FIELDS):
        c[:, lo : lo + n] = cf[at : at + f].view(f, *eg_w.shape)
        at += f


def eg_rows_value(x: EgRowsInputs, eg_w: torch.Tensor, lo: int, partial: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weighted residuals `[n, kb, B³]` of the frame rows `[lo, lo + n)`
    and their per-block r² sums (`partial_blocks(n·kb·B³)` floats, written
    into `partial` when given). One kernel launch on CUDA tensors,
    `eg_rows_plain` on CPU tensors."""
    eg_w = eg_w.contiguous()
    m = eg_w.numel()
    nblk = partial_blocks(m)
    if partial is None:
        partial = eg_w.new_empty(nblk)
    elif partial.shape != (nblk,) or partial.dtype != torch.float32 or not partial.is_contiguous():
        raise ValueError(f"partial {tuple(partial.shape)} {partial.dtype}: expected contiguous float32 ({nblk},)")
    _check(x, eg_w, lo)
    if eg_w.is_cuda:
        r = torch.empty_like(eg_w)
        _launch(x, eg_w, lo, r, None, 0, partial)
        return r, partial
    r, _ = eg_rows_plain(x, eg_w, lo, lin=False)
    partial.copy_(_value_partials(r))
    return r.view(eg_w.shape), partial
