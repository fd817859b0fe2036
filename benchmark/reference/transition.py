"""What happens to the grid between two refinement levels
(algorithms.cpp:202-237, 368-458): the 2x upsample, whose 8 children of a
voxel take the trilinear mean of the parent's valid corners (weight kept
only with more than 4 of them), and the thin-shell sparsify, which keeps the
valid voxels within the shell, their stencil support, and every voxel with a
sign change within its 5x5x5 neighbourhood."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.common import CORNERS8, RING6, VoxelTable, pack, quantile

_SUPPORT = RING6 + ((2, 0, 0), (0, 2, 0), (0, 0, 2))


def upsample(coords, fields: dict, dtype) -> tuple:
    """Children (coords `[8N, 3]` in key order, fields) of a parent grid:
    `fields` holds sdf, weight, color `[N, 3]`, albedo and sdf_refined."""
    dev = coords.device
    c = coords.to(torch.int64)
    offs = torch.tensor(CORNERS8, dtype=torch.int64, device=dev)
    idx = VoxelTable(c).find(c[:, None, :] + offs[None])  # [N, 8] parent corners
    wgt = torch.as_tensor(fields["weight"], device=dev).to(dtype)
    valid = (idx >= 0) & (wgt[idx.clamp(min=0)] > 0)
    half = offs.to(dtype) * 0.5
    w8 = torch.where(offs[None, :, :] == 1, half[:, None, :], 1.0 - half[:, None, :]).prod(-1)  # [child, corner]
    w = torch.where(valid[:, None, :], w8[None], torch.zeros((), dtype=dtype, device=dev))  # [N, c, k]
    wsum = w.sum(-1)
    wsafe = torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    cnt = valid.sum(-1)

    def avg(field):
        v = torch.as_tensor(field, device=dev).to(dtype)[idx.clamp(min=0)]  # [N, 8(, 3)]
        if v.dim() == 3:
            return (torch.einsum("nck,nkd->ncd", w, v) / wsafe[..., None]).reshape(-1, 3)
        return (torch.einsum("nck,nk->nc", w, v) / wsafe).reshape(-1)

    out = {k: avg(fields[k]) for k in ("sdf", "color", "albedo", "sdf_refined")}
    out["weight"] = torch.clamp(torch.where((cnt > 4)[:, None], (torch.einsum("nck,nk->nc", w, wgt[idx.clamp(min=0)])
                                                                  / wsafe), 0.0), min=0.0).reshape(-1)
    child = ((2 * c)[:, None, :] + offs[None]).reshape(-1, 3)
    order = torch.argsort(pack(child))
    return child[order], {k: v[order] for k, v in out.items()}


def sparsify(coords, sdfr, weight, thres: float) -> torch.Tensor:
    """Keep mask of the thin-shell sparsify."""
    dev = coords.device
    lo = coords.min(0).values - 2
    shape = (coords.max(0).values - lo + 3).tolist()
    c = coords - lo
    core_v = (weight > 0) & (torch.abs(sdfr.double()) <= thres)

    def dense(v):
        d = torch.zeros(shape, dtype=v.dtype, device=dev)
        d[c[:, 0], c[:, 1], c[:, 2]] = v
        return d

    core = dense(core_v)
    keep = core.clone()
    nx, ny, nz = shape
    for ox, oy, oz in _SUPPORT:
        keep[max(ox, 0):nx + min(ox, 0), max(oy, 0):ny + min(oy, 0), max(oz, 0):nz + min(oz, 0)] |= core[
            max(-ox, 0):nx + min(-ox, 0), max(-oy, 0):ny + min(-oy, 0), max(-oz, 0):nz + min(-oz, 0)]
    pos = dense(sdfr >= 0).float()
    neg = dense(sdfr < 0).float()
    pool = lambda m: F.max_pool3d(m[None, None], 5, 1, 2)[0, 0] > 0  # noqa: E731
    cross = torch.where(dense(sdfr < 0), pool(pos), pool(neg))
    return (keep | cross)[c[:, 0], c[:, 1], c[:, 2]]


def compare_grids(port: dict, coords, fields: dict, voxel: float) -> dict:
    """Readings of a level's starting grid against the reference's: the
    share of voxels in one grid and not the other, and the 99th percentile
    over shared voxels of the largest per-voxel gap of sdf and sdf_refined
    (in voxels), weight (relative), albedo and colour (/ 255)."""
    dev = coords.device
    pc = torch.as_tensor(port["coords"], device=dev).to(torch.int64)
    j = VoxelTable(coords).find(pc)
    hit = j >= 0
    nh = int(hit.sum())
    n_union = coords.shape[0] + pc.shape[0] - nh
    jj = j[hit]
    f64 = torch.float64

    def p(k):
        return torch.as_tensor(port[k], device=dev).to(f64)[hit]

    def r(k):
        return fields[k].to(f64)[jj]

    gaps = [torch.abs(p("sdf") - r("sdf")) / voxel, torch.abs(p("sdf_refined") - r("sdf_refined")) / voxel,
            torch.abs(p("weight") - r("weight")) / torch.clamp(torch.abs(r("weight")), min=1e-12),
            torch.abs(p("albedo") - r("albedo")),
            torch.abs(p("color") - r("color")).max(-1).values / 255.0]
    gap = torch.stack(gaps, -1).max(-1).values
    return {"voxel_mismatch": (n_union - nh) / max(n_union, 1), "gap": quantile(gap, 0.99)}
