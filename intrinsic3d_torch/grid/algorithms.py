"""Grid-level SDF algorithms: distance-transform correction and cleanup.

Counterpart of the fusion-stage part of `intrinsic3d_tpu/grid/algorithms.py`
(reference ``libintrinsic3d/src/sdf/algorithms.cpp``). `correct_sdf` takes
one of two routes by the JAX package's own size rule: on the card, when the
grid's dense bounding box holds at most 300 M voxels, the sparse grid is
scattered into that box on the device and corrected by the dense sweep
kernel (`ops.distance_transform.correct_sdf_dense`); otherwise the Jacobi
sweeps gather over a 26-neighbour index table. Both reach the same fixed
point. The thin-shell sparsification and the 2× upsample wait for the
port's level driver.
"""

from __future__ import annotations

import numpy as np
import torch

from intrinsic3d_torch.device import resolve_device
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid, full_neighborhood_offsets
from intrinsic3d_torch.ops.distance_transform import correct_sdf_dense

_NB26 = full_neighborhood_offsets(1)
_NB26_DIST = np.linalg.norm(_NB26.astype(np.float64), axis=-1).astype(np.float32)

# the dense route's largest bounding box, in voxels (the JAX package's rule)
DENSE_MAX_VOXELS = 300_000_000


def _correct_sdf_table(sdf, weight, nbr26_idx, voxel_size: float, num_iter: int):
    """Jacobi distance-transform sweeps over a gather table
    (``algorithms.cpp:260-339``): a valid voxel takes the smallest-|·|
    candidate `sdf_nb + sgn_nb·‖Δ‖` of the valid same-sign neighbours that
    shrink |sdf|, and weight 1. Stops early once a sweep changes nothing
    (such a sweep is idempotent, so the result is the same)."""
    steps = torch.as_tensor(_NB26_DIST * np.float32(voxel_size), device=sdf.device)
    safe = torch.clamp(nbr26_idx, min=0)
    present = nbr26_idx >= 0
    for _ in range(num_iter):
        valid = weight > 0.0
        nb_ok = present & valid[safe]
        sdf_nb = sdf[safe]
        pos = sdf >= 0.0
        pos_nb = sdf_nb >= 0.0
        dist_nb = torch.where(pos_nb, sdf_nb + steps, sdf_nb - steps)
        improving = (
            nb_ok
            & (torch.abs(dist_nb) < torch.abs(sdf)[:, None])
            & (pos_nb == pos[:, None])
            & valid[:, None]
        )
        cand = torch.where(improving, torch.abs(dist_nb), torch.full_like(dist_nb, float("inf")))
        best = torch.argmin(cand, dim=-1)
        has = improving.any(dim=-1)
        if not bool(has.any()):
            break
        sdf = torch.where(has, torch.gather(dist_nb, 1, best[:, None])[:, 0], sdf)
        weight = torch.where(has, torch.ones_like(weight), weight)
    return sdf, weight


def _dense_box(grid: VoxelGrid):
    lo = grid.coords.min(axis=0)
    dims = (grid.coords.max(axis=0) - lo + 1).astype(np.int64)
    return lo, dims


def correct_sdf(grid: VoxelGrid, num_iter: int = 10, dense: bool | None = None, device="cuda") -> VoxelGrid:
    """Distance-transform correction of the fused SDF, in place on the grid,
    computed on `device`. `dense=None` picks the route: dense on the card
    when `0 < box ≤ DENSE_MAX_VOXELS`, the gather table otherwise."""
    dev = resolve_device(device)
    if grid.num_voxels == 0:
        return grid
    if dense is None:
        vol = int(np.prod(_dense_box(grid)[1]))
        dense = dev.type == "cuda" and 0 < vol <= DENSE_MAX_VOXELS
    if dense:
        return _correct_sdf_via_dense(grid, num_iter, dev)
    nbr26 = grid.neighbor_table(_NB26)
    sdf, weight = _correct_sdf_table(
        torch.as_tensor(grid.sdf, device=dev),
        torch.as_tensor(grid.weight, device=dev),
        torch.as_tensor(nbr26, dtype=torch.int64, device=dev),
        grid.voxel_size,
        num_iter,
    )
    grid.sdf = sdf.cpu().numpy()
    grid.weight = weight.cpu().numpy()
    return grid


def _correct_sdf_via_dense(grid: VoxelGrid, num_iter: int, dev: torch.device) -> VoxelGrid:
    """Scatter the sparse grid into its dense box on `dev` (0 = absent),
    run the dense sweeps, gather back."""
    lo, dims = _dense_box(grid)
    c = torch.as_tensor(grid.coords - lo, dtype=torch.int64, device=dev)
    flat = (c[:, 0] * int(dims[1]) + c[:, 1]) * int(dims[2]) + c[:, 2]
    shape = tuple(int(d) for d in dims)
    dense_sdf = torch.zeros(shape, dtype=torch.float32, device=dev)
    dense_w = torch.zeros(shape, dtype=torch.float32, device=dev)
    dense_sdf.view(-1)[flat] = torch.as_tensor(grid.sdf, dtype=torch.float32, device=dev)
    dense_w.view(-1)[flat] = torch.as_tensor(grid.weight, dtype=torch.float32, device=dev)
    out_s, out_w = correct_sdf_dense(dense_sdf, dense_w, grid.voxel_size, num_iter)
    grid.sdf = out_s.view(-1)[flat].cpu().numpy()
    grid.weight = out_w.view(-1)[flat].cpu().numpy()
    return grid


def clear_invalid_voxels(grid: VoxelGrid) -> VoxelGrid:
    """Drop voxels with weight ≤ 0 (``algorithms.cpp:342-365``)."""
    return grid.select(grid.valid_mask())


def apply_refined_sdf(grid: VoxelGrid) -> VoxelGrid:
    """`sdf ← sdf_refined` (``algorithms.cpp:250-257``)."""
    grid.sdf = grid.sdf_refined.copy()
    return grid
