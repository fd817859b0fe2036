"""SDF debug visualization: voxel color modes → mesh PLY export.

Counterpart of `intrinsic3d_tpu/visualization.py` (reference
``nv::SDFVisualization``, ``libintrinsic3d/src/sdf/visualization.cpp``): swap
the grid's colors for a chosen scalar or vector field, extract the surface,
optionally keep only the largest component, and write a PLY per mode. The
per-voxel fields are computed in torch on the caller's device; the mesh
extraction and the PLY writer are host numpy.

Modes (``visualization.cpp:72-89``): "" (voxel colors), normals, lap, lum,
lum_grad, albedo, shading_sv, shading_sv_const, chroma, subvol, subvol_interp.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from intrinsic3d_torch.color import chromacity, intensity, scalar_to_color
from intrinsic3d_torch.config import RefinementConfig
from intrinsic3d_torch.device import resolve_device
from intrinsic3d_torch.grid import ops as gops
from intrinsic3d_torch.grid.voxel_grid import NORMAL_OFFSETS, RING6_OFFSETS, VoxelGrid
from intrinsic3d_torch.io.ply import save_ply
from intrinsic3d_torch.lighting.sh import compute_shading
from intrinsic3d_torch.mesh import extract_surface, remove_loose_components

log = logging.getLogger("intrinsic3d")


def output_modes(cfg: RefinementConfig, add_voxel_colors: bool = True) -> List[str]:
    """Enabled color modes from the stage config (``visualization.cpp:72-89``)."""
    modes = [""] if add_voxel_colors else []
    flags = [
        (cfg.output_mesh_normals, "normals"),
        (cfg.output_mesh_laplacian, "lap"),
        (cfg.output_mesh_intensity, "lum"),
        (cfg.output_mesh_intensity_grad, "lum_grad"),
        (cfg.output_mesh_albedo, "albedo"),
        (cfg.output_mesh_shading_sv, "shading_sv"),
        (cfg.output_mesh_shading_sv_const, "shading_sv_const"),
        (cfg.output_mesh_chromacity, "chroma"),
        (cfg.output_mesh_subvolumes, "subvol"),
        (cfg.output_mesh_subvolumes_interpolated, "subvol_interp"),
    ]
    modes += [name for on, name in flags if on]
    return modes


def _normals(grid: VoxelGrid, t):
    nbr4 = t(grid.neighbor_table(NORMAL_OFFSETS), torch.int64)
    sdf = t(grid.sdf_refined if grid.is_sbr else grid.sdf)
    return gops.surface_normals(sdf, nbr4, t(grid.valid_mask(), torch.bool))


def _ring_valid(grid: VoxelGrid, t):
    ring = grid.neighbor_table(RING6_OFFSETS)
    ok = np.all((ring >= 0) & grid.valid_mask()[np.maximum(ring, 0)], axis=-1)
    return t(ring, torch.int64), t(ok, torch.bool)


def colorize(grid: VoxelGrid, mode: str, lighting=None, device="cuda") -> np.ndarray:
    """Colors `[N, 3]` 0..255 for one visualization mode; `lighting` is the
    level's SVSH result (shading and subvolume modes)."""
    dev = resolve_device(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def host(x: torch.Tensor) -> np.ndarray:
        return x.cpu().numpy()

    if mode == "":
        return grid.color.copy()
    if mode == "normals":
        n, ok = _normals(grid, t)
        return host(torch.where(ok.unsqueeze(-1), 0.5 * n + 0.5, torch.zeros_like(n)) * 255.0)
    if mode == "lap":
        ring, ok = _ring_valid(grid, t)
        lap = gops.laplacian(t(grid.sdf_refined if grid.is_sbr else grid.sdf), ring) / grid.truncation
        return host(scalar_to_color(torch.where(ok, 0.5 * lap + 0.5, torch.zeros_like(lap))))
    if mode == "lum":
        return host(scalar_to_color(intensity(t(grid.color)), 0.0, 255.0))
    if mode == "lum_grad":
        ring, ok = _ring_valid(grid, t)
        lum = intensity(t(grid.color))
        # forward x-difference of luma (``visualization.cpp:318-341``)
        grad_x = torch.where(ok, lum[torch.clamp(ring[:, 0], min=0)] - lum, torch.zeros_like(lum))
        return host(torch.clamp(grad_x * 0.5 + 127.0, 0.0, 255.0).unsqueeze(-1).expand(-1, 3))
    if mode == "albedo":
        return host(scalar_to_color(t(grid.albedo)))
    if mode in ("shading_sv", "shading_sv_const"):
        if lighting is None:
            raise ValueError(f"mode {mode} needs an SVSH lighting result")
        n, ok = _normals(grid, t)
        sh = lighting.subvolumes.interpolate_values(lighting.coeffs, grid.voxel_to_world())
        albedo = t(grid.albedo)
        if mode.endswith("const"):
            albedo = torch.full_like(albedo, 0.7)
        shading = compute_shading(t(sh), n, albedo)
        return host(scalar_to_color(torch.where(ok, shading, torch.zeros_like(shading))))
    if mode == "chroma":
        return host(torch.clamp(chromacity(t(grid.color)) * 255.0 * 0.5, 0.0, 255.0))
    if mode in ("subvol", "subvol_interp"):
        if lighting is None:
            raise ValueError(f"mode {mode} needs an SVSH lighting result")
        sub = lighting.subvolumes
        rng = np.random.default_rng(0)
        sub_colors = rng.integers(0, 256, size=(sub.count, 3)).astype(np.float32)
        pts = grid.voxel_to_world()
        if mode == "subvol":
            ids = sub.point_to_subvolume(pts)
            return np.where(ids[:, None] >= 0, sub_colors[np.maximum(ids, 0)], grid.color)
        return np.clip(sub.interpolate_values(sub_colors, pts), 0, 255)
    raise ValueError(f"unknown visualization mode: {mode}")


def export_mesh(
    grid: VoxelGrid,
    prefix: str,
    mode: str = "",
    lighting=None,
    largest_comp_only: bool = True,
    suffix: str = "",
    device="cuda",
) -> Optional[str]:
    """Colorize + marching extraction + PLY (``visualization.cpp:180-222``).

    The mesh filename is `{prefix}{suffix}[_{mode}].ply`, the reference's
    naming. Uses sdf_refined for geometry when present."""
    colors = colorize(grid, mode, lighting, device=device)
    sdf = grid.sdf_refined if grid.is_sbr else grid.sdf
    verts, faces, vcols = extract_surface(grid, sdf=sdf, colors=colors)
    if largest_comp_only and len(faces):
        verts, faces, vcols = remove_loose_components(verts, faces, vcols)
    name = prefix + suffix + (f"_{mode}" if mode else "") + ".ply"
    save_ply(name, verts, faces, vcols)
    log.info("exported %s (%d verts, %d faces)", name, len(verts), len(faces))
    return name
