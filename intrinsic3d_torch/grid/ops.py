"""SDF differential operators over the flat voxel table (counterpart of
`intrinsic3d_tpu/grid/ops.py`, reference ``operators.cpp:46-77``,
``operators.h:70-109``). Stencils come as gather index tables (−1 = absent)
instead of per-voxel hash probes, so one call covers the whole grid."""

from __future__ import annotations

import torch


def gather_field(field: torch.Tensor, idx: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """`field[idx]` with −1 → `fill`."""
    out = field[torch.clamp(idx, min=0)]
    mask = idx >= 0
    if out.dim() > mask.dim():
        mask = mask.unsqueeze(-1)
    return torch.where(mask, out, torch.full_like(out, fill))


def surface_normals(sdf: torch.Tensor, nbr4_idx: torch.Tensor, valid: torch.Tensor):
    """Forward-difference normals of every voxel (``operators.cpp:58-77``).

    `nbr4_idx [N, 4]` indexes the {center, +x, +y, +z} stencil and `valid
    [N]` is the weight > 0 mask; a voxel needs itself and its three forward
    neighbours valid, else its normal is zero. Returns (normals `[N, 3]`,
    normal_valid `[N]`)."""
    nb_valid = torch.all((nbr4_idx >= 0) & valid[torch.clamp(nbr4_idx, min=0)], dim=-1)
    s = gather_field(sdf, nbr4_idx)  # [N, 4]
    n = torch.stack([s[:, 1] - s[:, 0], s[:, 2] - s[:, 0], s[:, 3] - s[:, 0]], dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    nonzero = norm[:, 0] > 0.0
    zero = torch.zeros_like(n)
    n = torch.where(nonzero.unsqueeze(-1), n / torch.where(norm == 0.0, torch.ones_like(norm), norm), zero)
    ok = nb_valid & nonzero
    return torch.where(ok.unsqueeze(-1), n, zero), ok


def compute_normal_from_sdf4(sdf4: torch.Tensor) -> torch.Tensor:
    """Differentiable normal from an `[..., 4]` stencil {center, +x, +y, +z}.
    The `+1e-24` under the square root keeps the reverse pass finite where
    the forward difference vanishes."""
    n = torch.stack(
        [
            sdf4[..., 1] - sdf4[..., 0],
            sdf4[..., 2] - sdf4[..., 0],
            sdf4[..., 3] - sdf4[..., 0],
        ],
        dim=-1,
    )
    norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-24)
    return n / norm


def laplacian(sdf: torch.Tensor, ring6_idx: torch.Tensor) -> torch.Tensor:
    """Discrete volumetric Laplacian over the 6-ring, un-normalized as in the
    residual form (``operators.h:88-109``). `ring6_idx [N, 6]` is ordered
    (+x, −x, +y, −y, +z, −z); an absent neighbour contributes the center
    value (no curvature)."""
    s6 = gather_field(sdf, ring6_idx, 0.0)
    s6 = torch.where(ring6_idx >= 0, s6, sdf.unsqueeze(-1))
    return torch.sum(s6, dim=-1) - 6.0 * sdf


def voxel_to_world(coords: torch.Tensor, voxel_size) -> torch.Tensor:
    """Integer voxel coords `[..., 3]` → float32 world positions."""
    return coords.to(torch.float32) * voxel_size


def voxel_center_to_iso(world_pts: torch.Tensor, normals: torch.Tensor, sdf: torch.Tensor) -> torch.Tensor:
    """Project voxel centers onto the iso-surface: `p − n·sdf`
    (``operators.cpp:46-56``)."""
    return world_pts - normals * sdf.unsqueeze(-1)
