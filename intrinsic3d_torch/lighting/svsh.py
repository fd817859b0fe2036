"""Spatially-varying spherical-harmonics lighting estimation.

Counterpart of `intrinsic3d_tpu/lighting/svsh.py` (reference
``libintrinsic3d/src/lighting/lighting_svsh.cpp``). The reference's residuals
`albedo·(H(n)·l) − lum` per thin-shell voxel and `l_i − l_j` per neighbouring
subvolume pair are linear in the 9 coefficients of each subvolume, so the
estimate is one block-sparse linear least-squares problem: the normal
equations are assembled on the device by scatter-adds over subvolume ids
(data weights normalized by 1/Σw, the regularizer by λ/P, as
``lighting_svsh.cpp:296-318``) and solved by PCG with a block-Jacobi
preconditioner. The per-voxel coefficients are then interpolated
trilinearly between subvolume centers on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from intrinsic3d_torch.color import intensity
from intrinsic3d_torch.device import resolve_device
from intrinsic3d_torch.grid import ops as gops
from intrinsic3d_torch.grid.voxel_grid import NORMAL_OFFSETS, VoxelGrid
from intrinsic3d_torch.lighting.sh import NUM_SH, sh_basis
from intrinsic3d_torch.lighting.subvolumes import Subvolumes
from intrinsic3d_torch.mathutil import sdf_to_weight


def _assemble_and_solve(H, albedo, lum, w, subvol, pairs, num_subvolumes: int, lambda_reg):
    """Normal equations of the data term, per subvolume: `A_s += w̃·a²·H Hᵀ`,
    `b_s += w̃·a·lum·H` with `w̃ = w / Σw`; then `solve_block_system`.
    `H [M, 9]`, `albedo, lum, w [M]`, `subvol [M]` ids, `pairs [P, 2]`."""
    s = num_subvolumes
    wsum = torch.sum(w)
    data_w = torch.where(wsum > 0, 1.0 / wsum, torch.ones_like(wsum)) * w
    ah = H * albedo.unsqueeze(-1)  # [M, 9]
    outer = ah.unsqueeze(-1) * ah.unsqueeze(-2) * data_w.view(-1, 1, 1)  # [M, 9, 9]
    a_blocks = ah.new_zeros(s, NUM_SH, NUM_SH).index_add_(0, subvol, outer)
    b = ah.new_zeros(s, NUM_SH).index_add_(0, subvol, ah * (data_w * lum).unsqueeze(-1))
    return solve_block_system(a_blocks, b, pairs, s, lambda_reg)


def normal_equation_parts(H, albedo, lum, w, subvol, num_subvolumes: int):
    """The data term's unnormalized normal equations over a set of voxels:
    (`A_u [S, 9, 9]` = Σ w·a²·H Hᵀ, `b_u [S, 9]` = Σ w·a·lum·H, Σw). Sums of
    these over disjoint voxel sets, scaled by 1/Σw, are the normal equations
    of their union (the sharded estimate all-reduces them,
    `parallel/spmd_stages.py`)."""
    ah = H * albedo.unsqueeze(-1)  # [M, 9]
    outer = ah.unsqueeze(-1) * ah.unsqueeze(-2) * w.view(-1, 1, 1)
    a_u = ah.new_zeros(num_subvolumes, NUM_SH, NUM_SH).index_add_(0, subvol, outer)
    b_u = ah.new_zeros(num_subvolumes, NUM_SH).index_add_(0, subvol, ah * (w * lum).unsqueeze(-1))
    return a_u, b_u, torch.sum(w)


def solve_block_system(A_blocks, b, pairs, num_subvolumes: int, lambda_reg):
    """PCG solve of (data blocks + graph Laplacian ⊗ I₉) x = b, `A_blocks
    [S, 9, 9]`, `b [S, 9]`, `pairs [P, 2]` directed neighbour pairs of
    regularizer weight λ/P each.

    The preconditioner is block-Jacobi: a Cholesky factor of each
    subvolume's diagonal block. The iteration and its stop are those of
    `jax.scipy.sparse.linalg.cg(tol=1e-8)`: x₀ = 0, stop when
    ‖r‖² ≤ 1e-16·‖b‖² or after max(9S, 100) steps. A jitter of 1e-10 keeps
    unobserved subvolumes invertible."""
    s = num_subvolumes
    p = int(pairs.shape[0])
    lam = torch.as_tensor(lambda_reg, dtype=b.dtype, device=b.device)
    reg_w = lam / max(p, 1) if p > 0 else torch.zeros_like(lam)
    i, j = pairs[:, 0].to(torch.int64), pairs[:, 1].to(torch.int64)
    deg = (torch.bincount(i, minlength=s) + torch.bincount(j, minlength=s)).to(b.dtype)
    jitter = 1e-10

    def matvec(x):
        y = torch.einsum("sab,sb->sa", A_blocks, x)
        diff = reg_w * (x[i] - x[j])
        y = y.index_add(0, i, diff)
        y = y.index_add(0, j, -diff)
        return y + jitter * x

    eye = torch.eye(NUM_SH, dtype=b.dtype, device=b.device)
    chol = torch.linalg.cholesky(A_blocks + (reg_w * deg + jitter).view(s, 1, 1) * eye)

    def precond(r):
        return torch.cholesky_solve(r.unsqueeze(-1), chol).squeeze(-1)

    def vdot(u, v):
        return torch.sum(u * v)

    tol2 = 1e-16 * vdot(b, b)
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    pdir = z
    gamma = vdot(r, z)
    for _ in range(max(9 * s, 100)):
        if not bool(vdot(r, r) > tol2):
            break
        ap = matvec(pdir)
        alpha = gamma / vdot(pdir, ap)
        x = x + alpha * pdir
        r = r - alpha * ap
        z = precond(r)
        gamma_new = vdot(r, z)
        pdir = z + (gamma_new / gamma) * pdir
        gamma = gamma_new
    return x


def trilerp_subvolumes(coeffs, pts, cell_tab, cell_origin, sub_size: float):
    """Per-point trilinear interpolation of subvolume coefficients `coeffs
    [S, 9]` at world points `pts [M, 3]` (``subvolumes.cpp:164-208``: −0.5
    center offset, missing corners weigh 0, the rest renormalized);
    `cell_tab` is `Subvolumes.cell_lookup`'s dense id volume at
    `cell_origin`. Corners are summed in the JAX package's order. Returns
    `[M, 9]`."""
    inv = torch.tensor(1.0 / np.float32(sub_size), dtype=pts.dtype, device=pts.device)
    p = pts * inv - 0.5
    base = torch.floor(p)
    frac = p - base
    bi = base.to(torch.int64) - cell_origin.to(torch.int64)
    dims = cell_tab.shape
    tab_flat = cell_tab.reshape(-1)
    m = pts.shape[0]
    acc = coeffs.new_zeros(m, NUM_SH)
    wsum = coeffs.new_zeros(m)
    for dx in (0, 1):
        wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
        ix = bi[:, 0] + dx
        for dy in (0, 1):
            wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
            iy = bi[:, 1] + dy
            for dz in (0, 1):
                wz = frac[:, 2] if dz else 1.0 - frac[:, 2]
                iz = bi[:, 2] + dz
                inb = (ix >= 0) & (ix < dims[0]) & (iy >= 0) & (iy < dims[1]) & (iz >= 0) & (iz < dims[2])
                flat = (torch.clamp(ix, 0, dims[0] - 1) * dims[1] + torch.clamp(iy, 0, dims[1] - 1)) * dims[
                    2
                ] + torch.clamp(iz, 0, dims[2] - 1)
                ids = torch.where(inb, tab_flat[flat], torch.full_like(flat, -1, dtype=tab_flat.dtype))
                w = torch.where(ids >= 0, wx * wy * wz, torch.zeros_like(wx))
                acc = acc + coeffs[torch.clamp(ids, min=0).to(torch.int64)] * w.unsqueeze(-1)
                wsum = wsum + w
    has = (wsum > 0.0).unsqueeze(-1)
    return torch.where(has, acc / torch.where(wsum == 0.0, torch.ones_like(wsum), wsum).unsqueeze(-1), 0.0)


def _estimate_full(
    sdfr, validm, nbr4, albedo, color, subvol, pairs, pts, cell_tab, cell_origin, sub_size: float,
    num_subvolumes: int, weighted: bool, lambda_reg, thres_shell, truncation,
):
    """The whole estimate over the voxel table: normals, SH basis,
    luminance, the data gate, the block solve and the per-voxel
    interpolation. Invalid voxels carry weight 0 and subvolume 0, which
    leaves the normal equations unchanged. Returns (coeffs `[S, 9]`, number
    of contributing voxels, per-voxel coefficients `[N, 9]`, zero outside
    the thin shell)."""
    normals, nvalid = gops.surface_normals(sdfr, nbr4, validm)
    H = sh_basis(normals)
    lum = intensity(color) / 255.0
    thres = torch.tensor(thres_shell, dtype=sdfr.dtype, device=sdfr.device)
    in_shell = validm & (torch.abs(sdfr) <= thres)
    valid = in_shell & nvalid & (albedo != 0.0) & ~torch.isnan(albedo) & (subvol >= 0)
    trunc = torch.tensor(truncation, dtype=sdfr.dtype, device=sdfr.device)
    w = sdf_to_weight(sdfr, trunc) if weighted else torch.ones_like(sdfr)
    w = torch.where(valid, w, torch.zeros_like(w))
    coeffs = _assemble_and_solve(
        H, albedo, lum, w, torch.clamp(subvol, min=0).to(torch.int64), pairs, num_subvolumes, lambda_reg
    )
    cvox = trilerp_subvolumes(coeffs, pts, cell_tab, cell_origin, sub_size)
    vox_sh = torch.where(in_shell.unsqueeze(-1), cvox, torch.zeros_like(cvox))
    return coeffs, torch.sum(valid), vox_sh


@dataclasses.dataclass
class SVSHResult:
    subvolumes: Subvolumes
    coeffs: np.ndarray  # [S, 9]


def estimate_svsh(
    grid: VoxelGrid,
    subvolume_size: float,
    lambda_reg: float,
    thres_shell: float,
    weighted: bool = True,
    with_voxel_sh: bool = False,
    nbr4: Optional[np.ndarray] = None,
    device="cuda",
):
    """Per-subvolume SH coefficients of `grid` (``lighting_svsh.cpp:166-346``),
    computed on `device`; None when no voxel contributes.

    `with_voxel_sh=True` also returns the per-voxel interpolated coefficients
    `[N, 9]` (numpy): the return is then `(SVSHResult | None, vox_sh |
    None)`. `nbr4` may pass the level's `[N, 4]` normal-stencil table. The
    JAX function's staged path for caller-supplied normals (tests and
    visualization) is not ported."""
    dev = resolve_device(device)
    none = (None, None) if with_voxel_sh else None
    if grid.num_voxels == 0 or thres_shell <= 0.0:
        return none
    pts = grid.voxel_to_world()
    sub = Subvolumes.compute(pts, subvolume_size)
    if sub.count == 0:
        return none
    subvol = sub.point_to_subvolume(pts)
    if nbr4 is None:
        nbr4 = grid.neighbor_table(NORMAL_OFFSETS)
    tab, origin = sub.cell_lookup()

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    coeffs, nvalid, vox_sh = _estimate_full(
        t(grid.sdf_refined), t(grid.valid_mask(), torch.bool), t(nbr4, torch.int64), t(grid.albedo),
        t(grid.color), t(subvol, torch.int64), t(sub.neighbor_pairs(), torch.int64), t(pts),
        t(tab, torch.int64), t(origin, torch.int64), sub.size, sub.count, weighted, lambda_reg,
        thres_shell, grid.truncation,
    )
    if int(nvalid) == 0:
        return none
    res = SVSHResult(subvolumes=sub, coeffs=coeffs.cpu().numpy())
    return (res, vox_sh.cpu().numpy()) if with_voxel_sh else res


def voxel_sh_coeffs(result: SVSHResult, grid: VoxelGrid, thres_shell: float) -> np.ndarray:
    """Per-voxel trilinearly interpolated SH coefficients, zero outside the
    thin shell (``lighting_svsh.cpp:93-110``); host numpy."""
    pts = grid.voxel_to_world()
    coeffs = result.subvolumes.interpolate_values(result.coeffs, pts)
    inside = grid.valid_mask() & (np.abs(grid.sdf_refined) <= thres_shell)
    return np.where(inside[:, None], coeffs, 0.0).astype(np.float32)
