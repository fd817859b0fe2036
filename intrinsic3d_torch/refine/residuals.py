"""Residual functions of the joint refinement energy.

Counterpart of `intrinsic3d_tpu/refine/residuals.py`. The four cost terms of
the reference (E = λ_g·E_g + λ_r·E_r + λ_s·E_s + λ_a·E_a):

- **E_g** gradient-based shading cost (``shading_cost.h:132-197``): per
  (voxel, observation) element, the 10-SDF/4-albedo forward-difference
  stencil → 4 normals → 4 iso-surface points → angle-axis rigid transform →
  distorted projection → bicubic intensity sample → SH shading →
  ‖∇shading − ∇I‖. Invalid configurations (projection out of the bicubic
  support, z ≤ 0) give residual 0 with zero gradient, the reference's
  `NV_INVALID_RESIDUAL` convention (``cost.h:45``).
- **E_r** volumetric Laplacian regularizer (``volumetric_regularizer.h:59-72``).
- **E_s** surface stabilization `sdf_refined − sdf_fused`
  (``surface_stab_regularizer.h:59-66``).
- **E_a** chromaticity-weighted pairwise albedo smoothness
  (``albedo_regularizer.h:59-66``).

Residuals are pre-scaled by √(w·λ̃), so the total cost is ½‖r‖² (Ceres'
ScaledLoss, ``nls_solver.cpp:236-249``). `eg_core` is the element body every
layout shares; `Assembly` and `all_residuals` are the flat-table form (the
JAX package's equivalence oracle), `refine/blockform.py` the block-dense one.
Every E_g sample goes through `ops.bicubic.bicubic_rows` — the CUDA kernel
on the card — where the JAX flat path samples through one-hot matmuls.

The JAX module's `rotate_angle_axis_batched` is `mathutil.rotate_angle_axis`
here (it broadcasts batched angle-axis vectors), and its `_catmull_rom_w` is
the sampler's own (`ops/bicubic.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from intrinsic3d_torch.grid.ops import compute_normal_from_sdf4
from intrinsic3d_torch.lighting.sh import sh_basis, shading_gradient_difference
from intrinsic3d_torch.mathutil import rotate_angle_axis
from intrinsic3d_torch.ops.bicubic import bicubic_rows


class Params(NamedTuple):
    """Optimizable parameters (the Ceres parameter blocks, flattened)."""

    sdf: torch.Tensor  # [N] table or [nb+1, B³] block-dense sdf_refined
    albedo: torch.Tensor  # same layout as sdf
    poses: torch.Tensor  # [K, 6] world→cam angle-axis + translation
    intr: torch.Tensor  # [4] fx fy cx cy (full resolution)
    dist: torch.Tensor  # [5] k1 k2 k3 p1 p2


class Assembly(NamedTuple):
    """Flat-table problem data of one outer iteration (rebuilt at every
    relinearization, as the reference re-collects observations,
    ``optimizer.cpp:119-156``; `refine.assembly.build_assembly`).

    The JAX package's `eg_onehot` field (a TPU device: the pose gather as a
    one-hot matrix product) has no counterpart here; `eg_residuals` gathers
    `poses[eg_frame]`. Index fields are int64."""

    # E_g — (voxel, observation) elements
    eg_sdf10_idx: torch.Tensor  # [M, 10] into sdf (stencil order of the reference)
    eg_alb4_idx: torch.Tensor  # [M, 4] into albedo {v, +x, +y, +z}
    eg_frame: torch.Tensor  # [M] keyframe index
    eg_w: torch.Tensor  # [M] observation·shell weight (0 = inactive)
    eg_sh: torch.Tensor  # [M, 9] per-voxel SH coefficients
    eg_vpos: torch.Tensor  # [M, 3] int32 voxel coords
    # E_r
    er_idx: torch.Tensor  # [N, 7] {center, +x, −x, +y, −y, +z, −z}
    er_w: torch.Tensor  # [N]
    # E_s
    es_idx: torch.Tensor  # [N] voxel of each anchor row
    es_ref: torch.Tensor  # [N] fused sdf anchor
    es_w: torch.Tensor  # [N]
    # E_a
    ea_pairs: torch.Tensor  # [P, 2] albedo index pairs
    ea_w: torch.Tensor  # [P] chromaticity weights
    # normalized per-type weights λ̃ = λ/Σw × 1000 (``nls_solver.cpp:379-394``)
    lam: torch.Tensor  # [4] for (E_g, E_r, E_s, E_a)
    images: torch.Tensor  # [K, H, W] intensity at the pyramid level
    pyr_scale: torch.Tensor  # scalar 2^-level
    voxel_size: torch.Tensor  # scalar


def catrom_sample_frames(images, fid, x, y, active=None):
    """Catmull-Rom bicubic sample of `images[fid]` at (x, y), batched over
    elements of any shape. Goes through `ops.bicubic.bicubic_rows` — the CUDA
    kernel on the card, its plain version on the CPU — for every batch size;
    `active` (0 = inactive: output 0, zero gradient) defaults to all ones.
    Differentiable in x and y."""
    shape = x.shape
    if active is None:
        active = torch.ones_like(x)
    out = bicubic_rows(
        images,
        fid.reshape(-1).to(torch.int32).contiguous(),
        x.reshape(-1).contiguous(),
        y.reshape(-1).contiguous(),
        active.reshape(-1).to(torch.float32).contiguous(),
    )
    return out.reshape(shape)


# positions of the 4 normal stencils inside the 10-value E_g SDF stencil
# (EG_SDF_OFFSETS order): normal(v), normal(v+x), normal(v+y), normal(v+z)
_N4 = ((0, 6, 1, 4), (6, 9, 7, 8), (1, 7, 2, 3), (4, 8, 3, 5))
_POINT_OFFSETS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1))


def eg_core(
    sdf10, alb4, pose6, intr4, dist5, sh9, vpos3, fid, images, pyr_scale, voxel_size,
    validity_only=False, active=None,
):
    """E_g residual body; every argument batched over elements `[..., C]`
    except `images [K, H, W]`. Returns the unweighted residual `[...]`.

    `validity_only=True` skips the image sampling and the shading and returns
    1.0/0.0 validity — exactly the `r != 0` predicate of the full evaluation
    (r = √(‖d‖²+1e-12) ≥ 1e-6 whenever valid), the creation-time residual
    probe (``shading_cost.cpp:136-147``). All four sample sites go through
    ONE sampler call (concatenated along the leading axis)."""
    h, w = images.shape[1], images.shape[2]
    fx = intr4[..., 0] * pyr_scale
    fy = intr4[..., 1] * pyr_scale
    cx = intr4[..., 2] * pyr_scale
    cy = intr4[..., 3] * pyr_scale

    shadings = []
    uvs = []
    valid = torch.ones(sdf10.shape[:-1], dtype=torch.bool, device=sdf10.device)
    aa = pose6[..., :3]
    t = pose6[..., 3:]
    # stencil columns are selected along a leading axis: indexing the last
    # axis makes the reverse pass a sort-based scatter over every element
    sdf10_c = sdf10.movedim(-1, 0)
    for k in range(4):
        sdf4 = sdf10_c[list(_N4[k])].movedim(0, -1)
        n = compute_normal_from_sdf4(sdf4)
        off = torch.tensor(_POINT_OFFSETS[k], dtype=sdf10.dtype, device=sdf10.device)
        p_world = (vpos3.to(sdf10.dtype) + off) * voxel_size - n * sdf4[..., :1]
        p_cam = rotate_angle_axis(aa, p_world) + t  # per-element angle-axis, broadcast
        z = p_cam[..., 2]
        z_ok = z > 1e-6
        zs = torch.where(z_ok, z, torch.ones_like(z))
        xn = torch.clamp(p_cam[..., 0] / zs, -10.0, 10.0)
        yn = torch.clamp(p_cam[..., 1] / zs, -10.0, 10.0)
        # distortion (3 radial + 2 tangential, ``camera.h:96-116``)
        r2 = xn * xn + yn * yn
        r4 = r2 * r2
        r6 = r4 * r2
        rad = 1.0 + dist5[..., 0] * r2 + dist5[..., 1] * r4 + dist5[..., 2] * r6
        xd = xn * rad + 2.0 * dist5[..., 3] * xn * yn + dist5[..., 4] * (r2 + 2.0 * xn * xn)
        yd = yn * rad + 2.0 * dist5[..., 4] * xn * yn + dist5[..., 3] * (r2 + 2.0 * yn * yn)
        u = fx * xd + cx
        v = fy * yd + cy
        # bicubic support needs u∈[1, W−2), v∈[1, H−2)
        valid = valid & z_ok & (u >= 1.0) & (u < w - 2) & (v >= 1.0) & (v < h - 2)
        if not validity_only:
            uvs.append((u, v))
            shadings.append(alb4[..., k] * torch.sum(sh9 * sh_basis(n), dim=-1))

    if validity_only:
        return valid.to(sdf10.dtype)
    us = torch.cat([u for u, _ in uvs], dim=0)
    vs = torch.cat([v for _, v in uvs], dim=0)
    fid4 = torch.cat([fid] * 4, dim=0)
    act4 = None if active is None else torch.cat([active] * 4, dim=0)
    lum4 = torch.stack(torch.chunk(catrom_sample_frames(images, fid4, us, vs, act4), 4, dim=0), dim=-1)
    sh4 = torch.stack(shadings, dim=-1)
    r = shading_gradient_difference(lum4, sh4)
    return torch.where(valid, r, torch.zeros_like(r))


def eg_elem(local29, sh9, vpos3, fid, images, pyr_scale, voxel_size, sqrt_wlam):
    """Weighted E_g residuals `[M]` from each element's 29 local parameters
    `local29 [M, 29]` {10 sdf, 4 albedo, 6 pose, 4 intr, 5 dist}: the
    per-element form whose Jacobian rows give the exact Jacobi diagonal
    (`refine.solver.jtj_diag`). Row m depends only on `local29[m]`."""
    r = eg_core(
        local29[..., :10],
        local29[..., 10:14],
        local29[..., 14:20],
        local29[..., 20:24],
        local29[..., 24:29],
        sh9,
        vpos3,
        fid,
        images,
        pyr_scale,
        voxel_size,
        active=(sqrt_wlam > 0).to(torch.float32),
    )
    return sqrt_wlam * r


def eg_residuals(params: Params, asm: Assembly) -> torch.Tensor:
    """Weighted E_g residual vector `[M]` (inactive elements are not
    sampled; their weight makes them 0 either way)."""
    sq = torch.sqrt(asm.eg_w * asm.lam[0])
    r = eg_core(
        params.sdf[asm.eg_sdf10_idx],
        params.albedo[asm.eg_alb4_idx],
        params.poses[asm.eg_frame],
        params.intr,
        params.dist,
        asm.eg_sh,
        asm.eg_vpos,
        asm.eg_frame,
        asm.images,
        asm.pyr_scale,
        asm.voxel_size,
        active=(sq > 0).to(torch.float32),
    )
    return sq * r


def er_residuals(params: Params, asm: Assembly) -> torch.Tensor:
    """Weighted Laplacian residuals `[N]` (``volumetric_regularizer.h:59-72``)."""
    s = params.sdf[asm.er_idx]  # [N, 7]
    lap = s[:, 1] + s[:, 2] + s[:, 3] + s[:, 4] + s[:, 5] + s[:, 6] - 6.0 * s[:, 0]
    return torch.sqrt(asm.er_w * asm.lam[1]) * lap


def es_residuals(params: Params, asm: Assembly) -> torch.Tensor:
    """Weighted surface-stabilization residuals `[N]`."""
    return torch.sqrt(asm.es_w * asm.lam[2]) * (params.sdf[asm.es_idx] - asm.es_ref)


def ea_residuals(params: Params, asm: Assembly) -> torch.Tensor:
    """Weighted albedo-pair residuals `[P]`."""
    a = params.albedo
    return torch.sqrt(asm.ea_w * asm.lam[3]) * (a[asm.ea_pairs[:, 0]] - a[asm.ea_pairs[:, 1]])


def all_residuals(params: Params, asm: Assembly) -> torch.Tensor:
    """Concatenated weighted residual vector — the whole NLS problem."""
    return torch.cat(
        [
            eg_residuals(params, asm),
            er_residuals(params, asm),
            es_residuals(params, asm),
            ea_residuals(params, asm),
        ]
    )


def total_cost(params: Params, asm: Assembly) -> torch.Tensor:
    r = all_residuals(params, asm)
    return 0.5 * torch.sum(r * r)
