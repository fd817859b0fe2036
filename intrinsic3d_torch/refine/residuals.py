"""E_g shading residual of the joint refinement energy.

Counterpart of the per-element part of `intrinsic3d_tpu/refine/residuals.py`
(reference ``shading_cost.h:132-197``): per (voxel, observation) element, the
10-SDF/4-albedo forward-difference stencil → 4 normals → 4 iso-surface points
→ angle-axis rigid transform → distorted projection → bicubic intensity
sample → SH shading → ‖∇shading − ∇I‖. Invalid configurations (projection
out of the bicubic support, z ≤ 0) give residual 0 with zero gradient, the
reference's `NV_INVALID_RESIDUAL` convention (``cost.h:45``).

The JAX module's `rotate_angle_axis_batched` is `mathutil.rotate_angle_axis`
here (it broadcasts batched angle-axis vectors), and its `_catmull_rom_w` is
the sampler's own (`ops/bicubic.py`). The flat-table `Assembly` and its
residual functions (the JAX package's equivalence oracle) are not part of
this slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from intrinsic3d_torch.grid.ops import compute_normal_from_sdf4
from intrinsic3d_torch.lighting.sh import sh_basis
from intrinsic3d_torch.mathutil import rotate_angle_axis
from intrinsic3d_torch.ops.bicubic import bicubic_rows


class Params(NamedTuple):
    """Optimizable parameters (the Ceres parameter blocks, flattened)."""

    sdf: torch.Tensor  # [N] table or [nb+1, B³] block-dense sdf_refined
    albedo: torch.Tensor  # same layout as sdf
    poses: torch.Tensor  # [K, 6] world→cam angle-axis + translation
    intr: torch.Tensor  # [4] fx fy cx cy (full resolution)
    dist: torch.Tensor  # [5] k1 k2 k3 p1 p2


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
    d = (sh4[..., 1:] - sh4[..., :1]) - (lum4[..., 1:] - lum4[..., :1])
    r = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
    return torch.where(valid, r, torch.zeros_like(r))
