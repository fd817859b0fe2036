"""The joint refinement's energy at a given state, the per-voxel observations
it rests on, and the recolour sweep that ends each level
(optimizer.cpp:119-361, shading_cost.h:132-197, colorization.cpp:162-370,
nls_solver.cpp:236-394).

E = λ_g·E_g + λ_r·E_r + λ_s·E_s + λ_a·E_a, each term's weights normalized
to λ / Σw × 1000, and the cost ½‖r‖². `assemble` returns each term's
weighted square sum and weight sum, so one assembly gives the cost under any
λ. Plain PyTorch in any dtype; the Catmull-Rom sampler is written out with
its 16 taps.
"""

from __future__ import annotations

import torch

from benchmark.reference.common import (
    EG_SDF10,
    N4_IN_10,
    NORMAL4,
    RING6,
    VoxelTable,
    distort,
    intensity,
    project,
    robust_kernel,
    rotate,
    sh_basis,
    surface_normals,
    transform,
)

_CHUNK = 1 << 18  # voxels a block


def _catrom_w(t):
    t2 = t * t
    t3 = t2 * t
    return (-0.5 * t + t2 - 0.5 * t3, 1.0 - 2.5 * t2 + 1.5 * t3, 0.5 * t + 2.0 * t2 - 1.5 * t3, -0.5 * t2 + 0.5 * t3)


def catrom(images, fid, x, y):
    """Catmull-Rom value of `images[fid]` at (x, y), coordinates clipped to
    [1, W - 2.001] and [1, H - 2.001]."""
    _, h, w = images.shape
    xc = torch.clamp(x, 1.0, w - 2.001)
    yc = torch.clamp(y, 1.0, h - 2.001)
    x0f, y0f = torch.floor(xc), torch.floor(yc)
    wx, wy = _catrom_w(xc - x0f), _catrom_w(yc - y0f)
    f = fid.long()
    x0, y0 = x0f.long() - 1, y0f.long() - 1
    val = torch.zeros_like(xc)
    for j in range(4):
        r = torch.zeros_like(xc)
        for i in range(4):
            r = r + wx[i] * images[f, y0 + j, x0 + i]
        val = val + wy[j] * r
    return val


def obs_weight(pt, n_cam, d):
    """Grazing-angle observation weight (colorization.cpp:274-315); its depth
    factor is the constant 1 of the upstream formula."""
    v = pt / torch.clamp(torch.linalg.vector_norm(pt, dim=-1, keepdim=True), min=1e-12)
    wn = torch.clamp(1.0 - torch.abs(torch.sum(v * n_cam, dim=-1)), 0.0, 1.0)
    wn = torch.clamp(robust_kernel(wn), min=0.001)
    wn = torch.where(torch.all(n_cam == 0, dim=-1), torch.zeros_like(wn), wn)
    d_norm = (torch.clamp(d, 0.01, 5.0) - 0.01) / (5.0 - 0.01)
    return wn * torch.clamp(torch.clamp(1.0 - d_norm, min=1.0), 0.001, 5.0)


def best_observations(poses, intr, dist, depths, iso, normals, occlusion, num_obs):
    """The `num_obs` best-weighted keyframes of each point: (weights `[N,
    B]`, frames `[N, B]`), ties to the lower frame; the depth probe is the
    nearest pixel, clamped into the image."""
    k, h, w = depths.shape
    pt = transform(poses[:, None, :], iso[None])  # [K, N, 3]
    n_cam = rotate(poses[:, None, :3], normals[None])
    u, v, ok = project(intr, dist, w, h, pt)
    ui = torch.floor(u + 0.5).to(torch.int64).clamp(0, w - 1)
    vi = torch.floor(v + 0.5).to(torch.int64).clamp(0, h - 1)
    d = depths[torch.arange(k, device=depths.device)[:, None], vi, ui]
    vis = (d > 0) & (torch.abs(d - pt[..., 2]) <= occlusion) if occlusion > 0 else torch.ones_like(ok)
    wt = torch.where(ok & vis & (d > 0), obs_weight(pt, n_cam, d), torch.zeros_like(d))
    order = torch.argsort(-wt.T, dim=1, stable=True)[:, :min(num_obs, k)]
    return torch.gather(wt.T, 1, order), order


def pyramid(colors, depths, levels: int, dtype):
    """Per pyramid level (intensity `[K, H, W]`, depth `[K, H, W]`) of
    keyframe colours in [0, 1] and depths: 5-tap [1 4 6 4 1]/16 blur with
    mirrored borders, then every second row and column; depth by the mean
    of each 2x2 cell's positive values (pyramid.cpp)."""
    c = colors.to(dtype)
    dep = depths.to(dtype)
    out = [(intensity(c), dep)]
    for _ in range(1, levels):
        for dim in (1, 2):
            n = c.shape[dim]
            i = torch.arange(-2, n + 2, device=c.device).abs()
            i = torch.where(i > n - 1, 2 * (n - 1) - i, i)
            p = torch.index_select(c, dim, i)
            acc = torch.zeros_like(c)
            for t, kk in enumerate((1.0, 4.0, 6.0, 4.0, 1.0)):
                acc = acc + p.narrow(dim, t, n) * (kk / 16.0)
            c = acc
        c = c[:, ::2, ::2]
        kf, h2, w2 = dep.shape[0], dep.shape[1] // 2, dep.shape[2] // 2
        cell = dep[:, :h2 * 2, :w2 * 2].reshape(kf, h2, 2, w2, 2).permute(0, 1, 3, 2, 4).reshape(kf, h2, w2, 4)
        pos = cell > 0
        cnt = pos.sum(-1)
        s = torch.where(pos, cell, torch.zeros_like(cell)).sum(-1)
        dep = torch.where(cnt > 0, s / cnt.clamp(min=1).to(dtype), torch.zeros_like(s))
        out.append((intensity(c), dep))
    return out


class Level:
    """One level's voxel state for the reference: coordinates, the fused
    anchor `sdf`, `weight`, colours (0..255) and the refined fields."""

    def __init__(self, coords, voxel, sdf, weight, color, sdfr, albedo, dtype, device):
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.coords = t(coords).to(torch.int64)
        self.voxel = float(voxel)
        self.sdf = t(sdf).to(dtype)
        self.valid = t(weight) > 0
        self.color = t(color).to(dtype)
        self.sdfr = t(sdfr).to(dtype)
        self.albedo = t(albedo).to(dtype)
        self.dtype = dtype
        self.table = VoxelTable(self.coords)
        self.nbr4 = self.table.stencil(NORMAL4)
        self.ring6 = self.table.stencil(RING6)
        self.eg10 = self.table.stencil(EG_SDF10)


def assemble(lv: Level, poses, intr, dist, sh, images, depths, thres, occlusion, num_obs, pyr_scale, at=None):
    """Each term's (Σ w·r², Σ w) of the problem linearized at the state of
    `lv` with `poses [K, 6]` (world to camera), full-resolution `intr`,
    `dist` and per-voxel SH `sh [N, 9]`, on one pyramid level's `images`
    and `depths`: the gates, observations and weights come from that state,
    and an E_g element that evaluates invalid there is dropped. The
    residuals are those at `at` = (sdf_refined, albedo, poses) when given
    (a trial state of the same linearization, as an LM try evaluates it),
    else at the linearization point. Returns a `[4, 2]` float64 tensor for
    (E_g, E_r, E_s, E_a)."""
    dt = lv.dtype
    s, a = lv.sdfr, lv.albedo
    se, ae, pe = (s, a, poses) if at is None else at
    n = s.shape[0]
    trunc = 5.0 * lv.voxel
    normals, nok = surface_normals(s, lv.nbr4, lv.valid)
    in_shell = lv.valid & (torch.abs(s) <= thres)
    gate = in_shell & nok
    ring_ok = torch.all((lv.ring6 >= 0) & lv.valid[lv.ring6.clamp(min=0)], dim=-1)
    stencil_ok = torch.all(lv.eg10 >= 0, dim=-1)
    w_sdf = torch.clamp(1.0 - torch.clamp(torch.abs(s), max=trunc) / trunc, 0.01, 1.0)
    intr_l = intr.to(dt) * pyr_scale
    pts = lv.coords.to(dt) * lv.voxel
    iso = pts - normals * s[:, None]
    out = torch.zeros((4, 2), dtype=torch.float64, device=s.device)
    for beg in range(0, n, _CHUNK):
        sl = slice(beg, min(beg + _CHUNK, n))
        ow, of = best_observations(poses, intr_l, dist, depths, iso[sl], normals[sl], occlusion, num_obs)
        ew = torch.where((gate[sl] & stencil_ok[sl])[:, None], ow * w_sdf[sl, None], torch.zeros_like(ow))
        vi, bi = torch.nonzero(ew > 0, as_tuple=True)
        vox, fr = vi + beg, of[vi, bi]
        st10, st4 = lv.eg10[vox], lv.nbr4[vox].clamp(min=0)
        r = eg_residual(s[st10], a[st4], poses[fr], intr_l, dist, sh[vox], lv.coords[vox], fr, images, lv.voxel)
        wr = ew[vi, bi] * (r != 0)
        if at is not None:
            r = eg_residual(se[st10], ae[st4], pe[fr], intr_l, dist, sh[vox], lv.coords[vox], fr, images, lv.voxel)
        out[0, 0] += torch.sum(wr.double() * r.double() ** 2)
        out[0, 1] += torch.sum(wr.double())
    er = (gate & ring_ok).to(dt)
    ring = lv.ring6.clamp(min=0)
    lap = se[ring].sum(-1) - 6.0 * se
    out[1] = torch.stack([torch.sum((er * lap * lap).double()), torch.sum(er.double())])
    es = gate.to(dt)
    out[2] = torch.stack([torch.sum((es * (se - lv.sdf) ** 2).double()), torch.sum(es.double())])
    src = torch.arange(n, device=s.device).repeat_interleave(6)
    dst = lv.ring6.reshape(-1)
    keep = dst > src
    i, j = src[keep], dst[keep]
    act = gate & ring_ok
    c01 = lv.color / 255.0
    lum = intensity(lv.color)
    lum = torch.where(lum == 0, torch.full_like(lum, 1e-12), lum)
    chroma = c01 / lum[:, None]
    wa = torch.clamp(1.0 - torch.linalg.vector_norm(chroma[i] - chroma[j], dim=-1), min=0.01)
    wa = torch.where(torch.isfinite(wa) & (act[i] | act[j]), wa, torch.zeros_like(wa))
    out[3] = torch.stack([torch.sum((wa * (ae[i] - ae[j]) ** 2).double()), torch.sum(wa.double())])
    return out


def cost(parts, lambdas) -> float:
    """½‖r‖² of assembled terms under raw weights (λ_g, λ_r, λ_s, λ_a)."""
    total = 0.0
    for t in range(4):
        sw, wsum = float(parts[t, 0]), float(parts[t, 1])
        if wsum > 0 and lambdas[t] > 0:
            total += lambdas[t] / wsum * 1000.0 * sw
    return 0.5 * total


def eg_residual(sdf10, alb4, pose6, intr_l, dist, sh9, vpos, fid, images, voxel):
    """‖∇shading − ∇I‖ over the forward differences of the 4 points
    {v, v+x, v+y, v+z}, each moved onto the iso-surface along its normal,
    transformed, projected and sampled; 0 where a point projects outside
    [1, W-2) x [1, H-2) or behind the camera."""
    dt = sdf10.dtype
    h, w = images.shape[1], images.shape[2]
    offs = torch.tensor(NORMAL4, dtype=dt, device=sdf10.device)
    valid = torch.ones(sdf10.shape[0], dtype=torch.bool, device=sdf10.device)
    lum, shade = [], []
    for k in range(4):
        s4 = sdf10[:, list(N4_IN_10[k])]
        nv = torch.stack([s4[:, 1] - s4[:, 0], s4[:, 2] - s4[:, 0], s4[:, 3] - s4[:, 0]], dim=-1)
        nv = nv / torch.sqrt(torch.sum(nv * nv, dim=-1, keepdim=True) + 1e-24)
        p = (vpos.to(dt) + offs[k]) * voxel - nv * s4[:, :1]
        pc = transform(pose6, p)
        z = pc[:, 2]
        zok = z > 1e-6
        zs = torch.where(zok, z, torch.ones_like(z))
        xn = torch.clamp(pc[:, 0] / zs, -10.0, 10.0)
        yn = torch.clamp(pc[:, 1] / zs, -10.0, 10.0)
        xd, yd = distort(dist, xn, yn)
        u = intr_l[0] * xd + intr_l[2]
        v = intr_l[1] * yd + intr_l[3]
        valid = valid & zok & (u >= 1.0) & (u < w - 2) & (v >= 1.0) & (v < h - 2)
        lum.append(catrom(images, fid, u, v))
        shade.append(alb4[:, k] * torch.sum(sh9 * sh_basis(nv), dim=-1))
    lum4, sh4 = torch.stack(lum, -1), torch.stack(shade, -1)
    diff = (sh4[:, 1:] - sh4[:, :1]) - (lum4[:, 1:] - lum4[:, :1])
    r = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    return torch.where(valid, r, torch.zeros_like(r))


def recolor(lv: Level, poses, intr, dist, depths, colors_u8, occlusion, num_obs):
    """The level's closing recolour: each voxel's weighted mean of its best
    observations' bilinear colours (0..255); a voxel with none keeps its
    colour. `depths` and `colors_u8` are the full-resolution keyframes."""
    dt = lv.dtype
    k, h, w = depths.shape
    normals, _ = surface_normals(lv.sdfr, lv.nbr4, lv.valid)
    iso = lv.coords.to(dt) * lv.voxel - normals * lv.sdfr[:, None]
    cols = colors_u8.to(dt)
    out = torch.empty_like(lv.color)
    for beg in range(0, iso.shape[0], _CHUNK):
        sl = slice(beg, min(beg + _CHUNK, iso.shape[0]))
        ow, of = best_observations(poses, intr, dist, depths, iso[sl], normals[sl], occlusion, num_obs)
        acc = torch.zeros((ow.shape[0], 3), dtype=dt, device=iso.device)
        for b in range(ow.shape[1]):
            f = of[:, b]
            u, v, _ = project(intr, dist, w, h, transform(poses[f], iso[sl]))
            acc = acc + bilinear(cols, f, u, v) * ow[:, b:b + 1]
        ws = ow.sum(-1)
        new = acc / torch.clamp(ws, min=1e-12)[:, None]
        out[sl] = torch.where((ws > 0)[:, None], new, lv.color[sl])
    return out


def bilinear(images, fid, x, y):
    """Bilinear samples of `images[fid]` `[K, H, W, C]`; out-of-image taps
    weigh 0 and the rest are renormalized."""
    h, w = images.shape[1], images.shape[2]
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    wx1, wy1 = x - x0.to(x.dtype), y - y0.to(y.dtype)
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    z = torch.zeros_like(wx0)
    wx0 = torch.where((x0 >= 0) & (x0 < w), wx0, z)
    wx1 = torch.where((x0 + 1 >= 0) & (x0 + 1 < w), wx1, z)
    wy0 = torch.where((y0 >= 0) & (y0 < h), wy0, z)
    wy1 = torch.where((y0 + 1 >= 0) & (y0 + 1 < h), wy1, z)
    xa, xb = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    ya, yb = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    f = fid.long()
    acc = (images[f, ya, xa] * (wx0 * wy0)[:, None] + images[f, ya, xb] * (wx1 * wy0)[:, None]
           + images[f, yb, xa] * (wx0 * wy1)[:, None] + images[f, yb, xb] * (wx1 * wy1)[:, None])
    ws = (wx0 * wy0 + wx1 * wy0 + wx0 * wy1 + wx1 * wy1)[:, None]
    return torch.where(ws > 0, acc / torch.where(ws > 0, ws, torch.ones_like(ws)), torch.zeros_like(acc))
