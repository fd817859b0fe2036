"""Spatially-varying SH lighting (lighting_svsh.cpp:93-346,
subvolumes.cpp:143-239): the voxels' world positions fall into cubic
subvolumes; each subvolume's 9 coefficients minimize the weighted data
residuals albedo·(H(n)·l) − luminance over the thin shell (weights
normalized by their sum) plus λ/P·(l_i − l_j) over the P directed pairs of
neighbouring subvolumes. The normal equations are small (9 x subvolumes)
and solved directly; the per-voxel coefficients are the trilinear
interpolation between subvolume centres, zero outside the shell."""

from __future__ import annotations

import torch

from benchmark.reference.common import CORNERS8, RING6, VoxelTable, intensity, sh_basis, surface_normals


def voxel_sh(lv, thres: float, size: float, lambda_reg: float, with_cells: bool = False):
    """Per-voxel SH coefficients `[N, 9]` of the state of `lv` (an
    `energy.Level`), in its dtype (the solve in float32 or above); with
    `with_cells`, also (subvolume cell indices `[S, 3]`, coefficients `[S,
    9]`)."""
    dt = lv.dtype
    dev = lv.coords.device
    pts = lv.coords.to(torch.float32) * torch.tensor(lv.voxel, dtype=torch.float32)
    cell = torch.floor(pts.double() / size).to(torch.int64)
    cells, sub = torch.unique(cell, dim=0, return_inverse=True)
    s_count = cells.shape[0]
    normals, nok = surface_normals(lv.sdfr, lv.nbr4, lv.valid)
    H = sh_basis(normals)
    lum = intensity(lv.color) / 255.0
    in_shell = lv.valid & (torch.abs(lv.sdfr) <= thres)
    ok = in_shell & nok & (lv.albedo != 0) & ~torch.isnan(lv.albedo)
    trunc = 5.0 * lv.voxel
    w = torch.clamp(1.0 - torch.clamp(torch.abs(lv.sdfr), max=trunc) / trunc, 0.01, 1.0)
    w = torch.where(ok, w, torch.zeros_like(w))
    w = w / torch.sum(w)
    ah = H * lv.albedo[:, None]
    solve_dt = torch.float64 if dt == torch.float64 else torch.float32
    A = torch.zeros((s_count, 9, 9), dtype=solve_dt, device=dev)
    A.index_add_(0, sub, (ah[:, :, None] * ah[:, None, :] * w[:, None, None]).to(solve_dt))
    b = torch.zeros((s_count, 9), dtype=solve_dt, device=dev)
    b.index_add_(0, sub, (ah * (w * lum)[:, None]).to(solve_dt))

    tab = VoxelTable(cells)
    nb = tab.find(cells[:, None, :] + torch.tensor(RING6, device=dev)[None])
    src = torch.arange(s_count, device=dev).repeat_interleave(6)
    dst = nb.reshape(-1)
    src, dst = src[dst >= 0], dst[dst >= 0]
    reg = lambda_reg / max(int(src.numel()), 1)
    M = torch.zeros((s_count * 9, s_count * 9), dtype=solve_dt, device=dev)
    for s in range(s_count):
        M[s * 9:(s + 1) * 9, s * 9:(s + 1) * 9] = A[s]
    L = torch.zeros((s_count, s_count), dtype=solve_dt, device=dev)
    ones = torch.ones(src.numel(), dtype=solve_dt, device=dev)
    L.index_put_((src, src), ones, accumulate=True)
    L.index_put_((dst, dst), ones, accumulate=True)
    L.index_put_((src, dst), -ones, accumulate=True)
    L.index_put_((dst, src), -ones, accumulate=True)
    M = M + reg * torch.kron(L, torch.eye(9, dtype=solve_dt, device=dev)) + 1e-10 * torch.eye(
        s_count * 9, dtype=solve_dt, device=dev)
    coeffs = torch.linalg.solve(M, b.reshape(-1)).reshape(s_count, 9).to(dt)

    p = pts.double() / size - 0.5
    base = torch.floor(p)
    frac = (p - base).to(dt)
    base = base.to(torch.int64)
    acc = torch.zeros((p.shape[0], 9), dtype=dt, device=dev)
    wsum = torch.zeros(p.shape[0], dtype=dt, device=dev)
    for off in CORNERS8:
        o = torch.tensor(off, device=dev)
        ids = tab.find(base + o)
        wt = torch.ones_like(wsum)
        for a in range(3):
            wt = wt * (frac[:, a] if off[a] else 1.0 - frac[:, a])
        wt = torch.where(ids >= 0, wt, torch.zeros_like(wt))
        acc = acc + coeffs[ids.clamp(min=0)] * wt[:, None]
        wsum = wsum + wt
    out = torch.where((wsum > 0)[:, None], acc / torch.where(wsum > 0, wsum, torch.ones_like(wsum))[:, None], 0.0)
    out = torch.where(in_shell[:, None], out, torch.zeros_like(out))
    return (out, cells, coeffs) if with_cells else out


def compare_coefficients(cells, coeffs, ref_cells, ref_coeffs) -> float:
    """Largest |Δ| of subvolume coefficients over the largest reference
    coefficient; 1 when the subvolume sets differ."""
    j = VoxelTable(ref_cells).find(torch.as_tensor(cells, device=ref_cells.device))
    if j.numel() != ref_cells.shape[0] or bool((j < 0).any()):
        return 1.0
    c = torch.as_tensor(coeffs, device=ref_coeffs.device).double()
    return float(torch.max(torch.abs(c - ref_coeffs.double()[j])) / torch.max(torch.abs(ref_coeffs.double())))
