"""TSDF fusion of all frames into the sparse voxel grid: the scene bounds,
allocation by ray sampling and a 3x3x3 dilation, the weighted projective
TSDF and colour means, the distance-transform correction and the removal of
unseen voxels (sparse_voxel_grid.cpp:300-467, algorithms.cpp:260-365,
processing.cpp:74-235)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.common import VoxelTable, pack, robust_kernel


def erode(depth, k: int, max_diff: float = 0.5):
    """Zero pixels whose (2k+1)² window holds a zero or a jump > max_diff."""
    if k <= 0:
        return depth
    h, w = depth.shape[-2:]
    pad = F.pad(depth.reshape(-1, 1, h, w).float(), (k, k, k, k), mode="replicate").to(depth.dtype)
    pad = pad.reshape(*depth.shape[:-2], h + 2 * k, w + 2 * k)
    ok = depth != 0
    for dy in range(-k, k + 1):
        for dx in range(-k, k + 1):
            dn = pad[..., k + dy:k + dy + h, k + dx:k + dx + w]
            ok = ok & (dn != 0) & (torch.abs(dn - depth) <= max_diff)
    return torch.where(ok, depth, torch.zeros_like(depth))


def depth_normals(cam: dict, depth, dtype):
    """Central-difference cross-product normals of depth maps `[F, H, W]`,
    zero where a neighbour is missing, across a jump of 0.3 m or on the
    border (processing.cpp:74-126)."""
    h, w = depth.shape[-2:]
    xs = (torch.arange(w, dtype=dtype, device=depth.device) - cam["cx"]) / cam["fx"]
    ys = (torch.arange(h, dtype=dtype, device=depth.device) - cam["cy"]) / cam["fy"]
    v = torch.stack([xs[None, None, :] * depth, ys[None, :, None] * depth, depth], dim=-1)
    vx0, vx1 = torch.roll(v, 1, dims=-2), torch.roll(v, -1, dims=-2)
    vy0, vy1 = torch.roll(v, 1, dims=-3), torch.roll(v, -1, dims=-3)
    tx, ty = vx1 - vx0, vy1 - vy0
    n = torch.linalg.cross(ty, tx, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.where(norm == 0, torch.full_like(norm, 1e-12), norm)
    ok = ((v[..., 2] != 0) & (vx0[..., 2] != 0) & (vx1[..., 2] != 0) & (vy0[..., 2] != 0) & (vy1[..., 2] != 0)
          & (torch.linalg.vector_norm(tx, dim=-1) < 0.3) & (torch.linalg.vector_norm(ty, dim=-1) < 0.3))
    border = torch.zeros((h, w), dtype=torch.bool, device=depth.device)
    border[1:-1, 1:-1] = True
    return torch.where((ok & border)[..., None], n, torch.zeros_like(n))


def scene_bounds(cam: dict, poses, dmin, dmax, voxel, clip):
    """Voxel AABB (lo, hi) over every frame's frustum, cut by the clip
    box (float64, on the host)."""
    trunc = 5.0 * voxel
    corners = []
    for d in (dmin, dmax):
        for x, y in ((0, 0), (cam["width"] - 1, 0), (cam["width"] - 1, cam["height"] - 1), (0, cam["height"] - 1)):
            corners.append(((x - cam["cx"]) / cam["fx"] * d, (y - cam["cy"]) / cam["fy"] * d, d))
    c = torch.tensor(corners, dtype=torch.float64)
    P = poses.detach().cpu().to(torch.float64)
    wpts = torch.einsum("cj,fij->fci", c, P[:, :3, :3]) + P[:, None, :3, 3]
    lo = wpts.reshape(-1, 3).min(dim=0).values - trunc
    hi = wpts.reshape(-1, 3).max(dim=0).values + trunc
    if any(abs(b) > 0 for b in clip):
        lo = torch.maximum(lo, torch.tensor(clip[0::2], dtype=torch.float64))
        hi = torch.minimum(hi, torch.tensor(clip[1::2], dtype=torch.float64))
    return (torch.floor(lo / voxel).to(torch.int64) - 1).tolist(), (torch.ceil(hi / voxel).to(torch.int64) + 1).tolist()


def dense_sweeps(sdf, weight, voxel, iters: int = 10):
    """Jacobi distance-transform sweeps of a dense window (0 weight = absent
    or unseen): a valid voxel takes the first of its 26 neighbours, in dx,
    dy, dz order over -1, 0, 1, that is valid, has its sign and gives a
    smaller |sdf + sgn·|off|·voxel|; it then gets weight 1."""
    offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1) if (a, b, c) != (0, 0, 0)]
    x, y, z = sdf.shape
    for _ in range(iters):
        valid = weight > 0
        pos = sdf >= 0
        best_abs, best = torch.abs(sdf), sdf
        upd = torch.zeros_like(valid)
        sp = F.pad(sdf[None].float(), (1, 1, 1, 1, 1, 1))[0].to(sdf.dtype)
        vp = F.pad(valid[None].float(), (1, 1, 1, 1, 1, 1))[0] > 0
        for dx, dy, dz in offs:
            step = torch.tensor(math.sqrt(dx * dx + dy * dy + dz * dz), dtype=torch.float32).to(sdf.dtype) * voxel
            nb = sp[dx + 1:dx + 1 + x, dy + 1:dy + 1 + y, dz + 1:dz + 1 + z]
            pnb = nb >= 0
            cand = torch.where(pnb, nb + step, nb - step)
            imp = vp[dx + 1:dx + 1 + x, dy + 1:dy + 1 + y, dz + 1:dz + 1 + z] & valid & (pnb == pos) & (
                torch.abs(cand) < best_abs)
            best = torch.where(imp, cand, best)
            best_abs = torch.where(imp, torch.abs(cand), best_abs)
            upd = upd | imp
        sdf, weight = best, torch.where(upd, torch.ones_like(weight), weight)
    return sdf, weight


def fuse(depths, colors, poses, cam: dict, fusion: dict, dmin: float, dmax: float, dtype=torch.float64):
    """The fused grid of frames `depths [F, H, W]` (already cut to [dmin,
    dmax]), `colors [F, H, W, 3]` in [0, 1] and camera-to-world `poses [F,
    4, 4]`, computed in `dtype`: (coords `[N, 3]` int64 in key order, sdf,
    weight, color `[N, 3]` in [0, 255])."""
    dev = depths.device
    voxel = float(fusion["voxel_size"])
    trunc = 5.0 * voxel
    clip = [float(fusion[k]) for k in ("clip_x0", "clip_x1", "clip_y0", "clip_y1", "clip_z0", "clip_z1")]
    lo, hi = scene_bounds(cam, poses, dmin, dmax, voxel, clip)
    dims = [h - l + 1 for l, h in zip(lo, hi)]
    lo_t = torch.tensor(lo, dtype=torch.int64, device=dev)
    d = erode(depths.to(dtype), int(fusion["discont_window_size"]))

    h, w = d.shape[-2:]
    xs = (torch.arange(w, dtype=dtype, device=dev) - cam["cx"]) / cam["fx"]
    ys = (torch.arange(h, dtype=dtype, device=dev) - cam["cy"]) / cam["fy"]
    rays = torch.stack(torch.broadcast_tensors(xs[None, :], ys[:, None], torch.ones((), dtype=dtype, device=dev)), -1)
    steps = int(math.floor(2.0 * trunc / (0.25 * voxel))) + 1
    s = torch.arange(steps, dtype=dtype, device=dev) / (steps - 1)
    offs = -trunc * (1.0 - s) + trunc * s
    P = poses.to(dev, dtype)
    occ = torch.zeros(dims, dtype=torch.bool, device=dev)
    use_clip = any(abs(b) > 0 for b in clip)
    for f in range(d.shape[0]):
        dd = d[f][None] + offs[:, None, None]
        pts = (rays[None] * dd[..., None]) @ P[f, :3, :3].T + P[f, :3, 3]
        vox = torch.round(pts / voxel).to(torch.int64)
        idx = vox - lo_t
        ok = (d[f][None] > 0) & torch.isfinite(dd) & (idx >= 0).all(-1)
        ok &= (idx[..., 0] < dims[0]) & (idx[..., 1] < dims[1]) & (idx[..., 2] < dims[2])
        if use_clip:
            pw = vox.to(dtype) * voxel
            ok &= ((pw[..., 0] >= clip[0]) & (pw[..., 0] <= clip[1]) & (pw[..., 1] >= clip[2]) & (pw[..., 1] <= clip[3])
                   & (pw[..., 2] >= clip[4]) & (pw[..., 2] <= clip[5]))
        i = idx[ok]
        occ[i[:, 0], i[:, 1], i[:, 2]] = True
    occ = F.max_pool3d(occ[None, None].float(), 3, 1, 1)[0, 0] > 0
    coords = torch.nonzero(occ) + lo_t
    coords = coords[torch.argsort(pack(coords))]

    pts = coords.to(dtype) * voxel
    normals = depth_normals(cam, d, dtype)
    inv = torch.linalg.inv(poses.to(dev, torch.float64)).to(dtype)
    n = coords.shape[0]
    wsdf = torch.zeros(n, dtype=dtype, device=dev)
    wsum = torch.zeros_like(wsdf)
    wcol = torch.zeros((n, 3), dtype=dtype, device=dev)
    csum = torch.zeros_like(wsdf)
    ws = 10.0
    span = float(torch.tensor(dmax, dtype=torch.float32) - torch.tensor(dmin, dtype=torch.float32))
    col = colors.to(dev, dtype)
    for f in range(d.shape[0]):
        p = pts @ inv[f, :3, :3].T + inv[f, :3, 3]
        z = p[:, 2]
        zs = torch.where(z == 0, torch.full_like(z, 1e-12), z)
        ui = torch.floor(p[:, 0] * cam["fx"] / zs + cam["cx"] + 0.5).to(torch.int64)
        vi = torch.floor(p[:, 1] * cam["fy"] / zs + cam["cy"] + 0.5).to(torch.int64)
        ok = (z > 0) & (ui >= 0) & (vi >= 0) & (ui < w) & (vi < h)
        uc, vc = ui.clamp(0, w - 1), vi.clamp(0, h - 1)
        dep = d[f, vc, uc]
        ok &= dep > 0
        sdf = dep - z
        ok &= sdf > -trunc
        tsdf = torch.clamp(sdf, -trunc, trunc)
        nrm = normals[f, vc, uc]
        pn = torch.linalg.vector_norm(p, dim=-1)
        cos = torch.sum(p / torch.clamp(pn, min=1e-12)[:, None] * nrm, dim=-1)
        w_normal = torch.clamp(ws * robust_kernel(torch.clamp(1.0 - torch.abs(cos), 0.0, 1.0)), min=1.0)
        w_dist = torch.clamp(ws * robust_kernel(2.0 * torch.abs(tsdf) / trunc), min=1.0)
        w_depth = torch.clamp(ws * (1.0 - (dep - dmin) / span), min=1.0)
        wu = torch.where(ok, torch.clamp((w_normal + w_dist + w_depth) / 3.0, min=3.0), torch.zeros_like(sdf))
        wsdf += wu * sdf
        wsum += wu
        cok = ok  # one camera for depth and colour
        cw = torch.where(cok, wu, torch.zeros_like(wu))
        wcol += cw[:, None] * col[f, vc, uc] * 255.0
        csum += cw
    seen = wsum > 0
    sdf = torch.where(seen, wsdf / torch.clamp(wsum, min=1e-12), torch.zeros_like(wsdf))
    color = torch.where((csum > 0)[:, None], wcol / torch.clamp(csum, min=1e-12)[:, None], torch.zeros_like(wcol))

    # distance-transform correction on the grid's dense box, then the unseen
    # voxels go (the correction gives weight 1 to the voxels it fills)
    lo_b = coords.min(dim=0).values
    box = (coords.max(dim=0).values - lo_b + 1).tolist()
    c = coords - lo_b
    flat = (c[:, 0] * box[1] + c[:, 1]) * box[2] + c[:, 2]
    ds = torch.zeros(box, dtype=dtype, device=dev)
    dw = torch.zeros(box, dtype=dtype, device=dev)
    ds.view(-1)[flat] = sdf
    dw.view(-1)[flat] = wsum
    ds, dw = dense_sweeps(ds, dw, voxel)
    sdf, weight = ds.view(-1)[flat], dw.view(-1)[flat]
    keep = weight > 0
    return coords[keep], sdf[keep], weight[keep], color[keep]


def compare_fused(port: dict, ref, voxel: float) -> dict:
    """The fused grid's readings: the share of voxels in one grid and not
    the other, and the 99th percentile over shared voxels of the largest of
    |Δsdf| / voxel, |Δweight| / weight and |Δcolor| / 255."""
    from benchmark.reference.common import quantile

    rc, rs, rw, rcol = ref
    dev = rc.device
    pc = torch.as_tensor(port["coords"], device=dev).to(torch.int64)
    tab = VoxelTable(rc)
    j = tab.find(pc)
    hit = j >= 0
    n_union = rc.shape[0] + pc.shape[0] - int(hit.sum())
    mismatch = (n_union - int(hit.sum())) / max(n_union, 1)
    jj = j[hit]
    f64 = torch.float64
    ps = torch.as_tensor(port["sdf"], device=dev).to(f64)[hit]
    pw = torch.as_tensor(port["weight"], device=dev).to(f64)[hit]
    pcol = torch.as_tensor(port["color"], device=dev).to(f64)[hit]
    gap = torch.stack([
        torch.abs(ps - rs[jj].to(f64)) / voxel,
        torch.abs(pw - rw[jj].to(f64)) / torch.clamp(torch.abs(rw[jj].to(f64)), min=1e-12),
        torch.abs(pcol - rcol[jj].to(f64)).max(dim=-1).values / 255.0,
    ], dim=-1).max(dim=-1).values
    return {"fusion_voxel_mismatch": mismatch, "fusion_gap": quantile(gap, 0.99)}
