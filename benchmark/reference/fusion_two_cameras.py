"""TSDF fusion of an RGB-D capture whose colour camera differs from its
depth camera: `fusion.fuse` with each voxel's depth looked up through the
depth camera and its colour through the colour camera, as the upstream's
integration does for a registered pair (sparse_voxel_grid.cpp:315-391; the
colour lookup :376-387). The grid, its sdf and its weights are
`fusion.fuse`'s on the depth camera; the colours are the same weighted
means, worked out again for the fused voxels with each frame's colour read
through the colour camera (a voxel's update depends on that voxel alone,
and a voxel the distance-transform correction filled has no colour).

Departures from the upstream are `fusion.fuse`'s; besides, a voxel whose
depth lookup is valid and whose colour pixel lies outside the colour image
adds its weight to the sdf and none to the colour, as the upstream skips
the colour update there.
"""

from __future__ import annotations

import torch

from benchmark.reference import fusion
from benchmark.reference.common import robust_kernel


def _pixel(p, zs, cam: dict):
    """The rounded pixel (u, v) of camera-frame points through `cam`."""
    u = torch.floor(p[:, 0] * cam["fx"] / zs + cam["cx"] + 0.5).to(torch.int64)
    v = torch.floor(p[:, 1] * cam["fy"] / zs + cam["cy"] + 0.5).to(torch.int64)
    return u, v


def fuse(depths, colors, poses, depth_cam: dict, color_cam: dict, cfg: dict, dmin: float, dmax: float,
         dtype=torch.float64):
    """The fused grid of frames `depths [F, Hd, Wd]` of `depth_cam` (already
    cut to [dmin, dmax]), `colors [F, Hc, Wc, 3]` in [0, 1] of `color_cam`
    and camera-to-world `poses [F, 4, 4]` shared by both cameras, computed in
    `dtype` with the configuration's fusion group `cfg`: (coords `[N, 3]`
    int64 in key order, sdf, weight, color `[N, 3]` in [0, 255])."""
    coords, sdf, weight, _ = fusion.fuse(depths, colors, poses, depth_cam, cfg, dmin, dmax, dtype=dtype)
    dev = depths.device
    voxel = float(cfg["voxel_size"])
    trunc = 5.0 * voxel
    d = fusion.erode(depths.to(dtype), int(cfg["discont_window_size"]))
    h, w = d.shape[-2:]
    normals = fusion.depth_normals(depth_cam, d, dtype)
    pts = coords.to(dtype) * voxel
    inv = torch.linalg.inv(poses.to(dev, torch.float64)).to(dtype)
    wcol = torch.zeros((coords.shape[0], 3), dtype=dtype, device=dev)
    csum = torch.zeros(coords.shape[0], dtype=dtype, device=dev)
    ws = 10.0
    span = float(torch.tensor(dmax, dtype=torch.float32) - torch.tensor(dmin, dtype=torch.float32))
    col = colors.to(dev, dtype)
    hc, wc = col.shape[1], col.shape[2]
    for f in range(d.shape[0]):
        # the integration weight of `fusion.fuse`, through the depth camera
        p = pts @ inv[f, :3, :3].T + inv[f, :3, 3]
        z = p[:, 2]
        zs = torch.where(z == 0, torch.full_like(z, 1e-12), z)
        ui, vi = _pixel(p, zs, depth_cam)
        ok = (z > 0) & (ui >= 0) & (vi >= 0) & (ui < w) & (vi < h)
        uc, vc = ui.clamp(0, w - 1), vi.clamp(0, h - 1)
        dep = d[f, vc, uc]
        ok &= dep > 0
        tsdf = dep - z
        ok &= tsdf > -trunc
        tsdf = torch.clamp(tsdf, -trunc, trunc)
        nrm = normals[f, vc, uc]
        pn = torch.linalg.vector_norm(p, dim=-1)
        cos = torch.sum(p / torch.clamp(pn, min=1e-12)[:, None] * nrm, dim=-1)
        w_normal = torch.clamp(ws * robust_kernel(torch.clamp(1.0 - torch.abs(cos), 0.0, 1.0)), min=1.0)
        w_dist = torch.clamp(ws * robust_kernel(2.0 * torch.abs(tsdf) / trunc), min=1.0)
        w_depth = torch.clamp(ws * (1.0 - (dep - dmin) / span), min=1.0)
        wu = torch.clamp((w_normal + w_dist + w_depth) / 3.0, min=3.0)
        # the colour through the colour camera
        uci, vci = _pixel(p, zs, color_cam)
        cok = ok & (uci >= 0) & (vci >= 0) & (uci < wc) & (vci < hc)
        cw = torch.where(cok, wu, torch.zeros_like(wu))
        wcol += cw[:, None] * col[f, vci.clamp(0, hc - 1), uci.clamp(0, wc - 1)] * 255.0
        csum += cw
    color = torch.where((csum > 0)[:, None], wcol / torch.clamp(csum, min=1e-12)[:, None], torch.zeros_like(wcol))
    return coords, sdf, weight, color
