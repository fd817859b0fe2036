"""Per-level gather topology, albedo chromaticity weights and the flat-table
problem assembly.

Counterpart of `intrinsic3d_tpu/refine/assembly.py` (reference
``Optimizer::addVoxelResiduals`` + ``fixVoxelParams``,
``optimizer.cpp:176-361``, ``albedo_regularizer.cpp:60-72``).
`LevelTopology`, `chroma_weights` and `_ea_weights` are host numpy copies;
`level_topology` memoizes the tables per grid. `build_assembly` is the
flat-table form — the JAX package's equivalence oracle, which the block path
is held against: the gates and the weight normalization on the host, the
normals, iso points, top-N observations (depth probe through the
`nearest_rows` kernel on the card) and the creation-time probe (through the
`bicubic_rows` kernel) on the device of `params`.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Tuple

import numpy as np
import torch

from intrinsic3d_torch.camera import Camera
from intrinsic3d_torch.device import check_on, resolve_device
from intrinsic3d_torch.grid import ops as gops
from intrinsic3d_torch.grid.voxel_grid import (
    EG_ALBEDO_OFFSETS,
    EG_SDF_OFFSETS,
    NORMAL_OFFSETS,
    RING6_OFFSETS,
    VoxelGrid,
)
from intrinsic3d_torch.observations import best_observations, compute_observations_batch
from intrinsic3d_torch.refine.residuals import Assembly, Params, eg_residuals
from intrinsic3d_torch.refine.solver import Masks


@dataclasses.dataclass
class LevelTopology:
    """Gather tables fixed for one grid level (the active set is frozen)."""

    eg_sdf10_idx: np.ndarray  # [N, 10]
    eg_alb4_idx: np.ndarray  # [N, 4]
    ring6_idx: np.ndarray  # [N, 6]
    nbr4_idx: np.ndarray  # [N, 4] normal stencil
    ea_pairs: np.ndarray  # [P, 2] unique undirected 6-ring pairs
    coords: np.ndarray  # [N, 3]

    @classmethod
    def build(cls, grid: VoxelGrid) -> "LevelTopology":
        ring6 = grid.neighbor_table(RING6_OFFSETS)
        # every undirected adjacency (i, j) appears once from each endpoint;
        # keeping src < dst dedups (the reference's voxels_added bookkeeping,
        # ``optimizer.cpp:268-274``), ordered as np.unique(axis=0) would
        src = np.repeat(np.arange(grid.num_voxels), 6)
        dst = ring6.reshape(-1)
        ok = dst > src  # absent neighbours are −1, excluded by > src ≥ 0
        pairs = np.stack([src[ok], dst[ok]], axis=-1)
        pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))].astype(np.int32)
        return cls(
            eg_sdf10_idx=grid.neighbor_table(EG_SDF_OFFSETS),
            eg_alb4_idx=grid.neighbor_table(EG_ALBEDO_OFFSETS),
            ring6_idx=ring6,
            nbr4_idx=grid.neighbor_table(NORMAL_OFFSETS),
            ea_pairs=pairs,
            coords=grid.coords.astype(np.int32),
        )


_TOPO_LOCK = threading.Lock()


def level_topology(grid: VoxelGrid) -> LevelTopology:
    """`LevelTopology.build` memoized per grid object. A grid's coordinates
    never change (structural passes return new grids), so the tables never
    go stale; every pyramid level of a grid level reuses them. The memo is
    locked: a level prep's thread (`refine.optimizer.LevelPrep`) and the
    main thread never both build a grid's tables."""
    with _TOPO_LOCK:
        topo = grid.__dict__.get("_topo_cache")
        if topo is None:
            topo = LevelTopology.build(grid)
            grid._topo_cache = topo
    return topo


def chroma_weights(colors: np.ndarray, pairs: np.ndarray) -> np.ndarray:
    """Chromaticity-difference weights of albedo pairs
    (``albedo_regularizer.cpp:60-72``); colors are 0..255 RGB. The reference
    divides [0,1]-scaled color by the [0,255]-scaled luma — kept verbatim."""
    c01 = colors / 255.0
    lum255 = 0.299 * colors[:, 0] + 0.587 * colors[:, 1] + 0.114 * colors[:, 2]
    lum255 = np.where(lum255 == 0.0, 1e-12, lum255)
    chroma = c01 / lum255[:, None]
    d = np.linalg.norm(chroma[pairs[:, 0]] - chroma[pairs[:, 1]], axis=-1)
    w = np.maximum(1.0 - d, 0.01)
    return np.where(np.isfinite(w), w, 0.0).astype(np.float32)


def build_assembly(
    grid: VoxelGrid,
    topo: LevelTopology,
    params: Params,  # table-order, on `device`
    cam_level: Camera,
    depths_level: torch.Tensor,  # [K, H, W] depth at the pyramid level
    images_level: torch.Tensor,  # [K, H, W] intensity at the pyramid level
    voxel_sh: np.ndarray,  # [N, 9]
    thres_shell: float,
    occlusion_distance: float,
    num_observations: int,
    lambda_g: float,
    lambda_r: float,
    lambda_s: float,
    lambda_a: float,
    pyr_scale: float,
    fix_poses: bool = False,
    fix_intrinsics: bool = False,
    fix_distortion: bool = False,
    min_pose_obs: int = 0,
    device="cuda",
) -> Tuple[Assembly, Masks]:
    """The flat-table problem at `params`: which voxels contribute which
    residuals, their observations with the current poses, the per-type
    normalized weights, and the free-parameter masks.

    The E_g elements are the (voxel, observation) pairs of positive weight,
    in `np.flatnonzero` order over `[N, B]` — the JAX package's order; its
    power-of-two padding (static shapes for XLA) is dropped. Elements the
    creation-time probe finds invalid keep their row with weight 0, as in
    the JAX package."""
    dev = resolve_device(device)
    check_on(dev, sdf=params.sdf, poses=params.poses, depths=depths_level, images=images_level)
    n = grid.num_voxels
    sdfr = params.sdf.detach().cpu().numpy()
    weight_valid = grid.valid_mask()

    def on_dev(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    with torch.no_grad():
        # normals from the current sdf_refined
        normals, nvalid = gops.surface_normals(
            params.sdf, on_dev(topo.nbr4_idx, torch.int64), on_dev(weight_valid, torch.bool)
        )
        normal_ok = nvalid.cpu().numpy()

        # residual-voxel gate (``optimizer.cpp:185-199``)
        in_shell = weight_valid & (np.abs(sdfr) <= thres_shell)
        gate = in_shell & normal_ok
        ring_ok = np.all((topo.ring6_idx >= 0) & weight_valid[np.maximum(topo.ring6_idx, 0)], axis=-1)

        # E_g observations with the current poses
        pts = topo.coords.astype(np.float32) * grid.voxel_size
        iso = gops.voxel_center_to_iso(on_dev(pts), normals, params.sdf)
        # the JAX package's `collect_observations`, its depth probe through
        # the `nearest_rows` kernel (the same weights)
        obs_w, obs_f = best_observations(
            compute_observations_batch(cam_level, params.poses, depths_level, iso, normals, occlusion_distance),
            num_observations,
        )
        obs_w = obs_w.cpu().numpy()  # [N, B]
        obs_f = obs_f.cpu().numpy()

    stencil_ok = np.all(topo.eg_sdf10_idx >= 0, axis=-1)
    w_sdf = np.clip(1.0 - np.minimum(np.abs(sdfr), grid.truncation) / grid.truncation, 0.01, 1.0)
    eg_gate = gate & stencil_ok
    eg_w = np.where(eg_gate[:, None], obs_w * w_sdf[:, None], 0.0)  # [N, B]

    # compact to the active elements
    eg_w = eg_w.reshape(-1).astype(np.float32)
    active = np.flatnonzero(eg_w > 0.0)
    eg_w = eg_w[active]
    eg_frame = obs_f.reshape(-1)[active].astype(np.int64)
    vox = active // obs_w.shape[1]  # voxel of each element

    er_w = np.where(gate & ring_ok, 1.0, 0.0).astype(np.float32) if lambda_r > 0.0 else np.zeros(n, np.float32)
    es_w = np.where(gate, 1.0, 0.0).astype(np.float32) if lambda_s > 0.0 else np.zeros(n, np.float32)
    ea_w = _ea_weights(grid, topo, gate, ring_ok, lambda_a)
    asm = Assembly(
        eg_sdf10_idx=on_dev(np.maximum(topo.eg_sdf10_idx, 0)[vox], torch.int64),
        eg_alb4_idx=on_dev(np.maximum(topo.eg_alb4_idx, 0)[vox], torch.int64),
        eg_frame=on_dev(eg_frame, torch.int64),
        eg_w=on_dev(eg_w),
        eg_sh=on_dev(voxel_sh.astype(np.float32)[vox]),
        eg_vpos=on_dev(topo.coords[vox], torch.int32),
        er_idx=on_dev(
            np.concatenate([np.arange(n)[:, None], np.maximum(topo.ring6_idx, 0)], axis=-1), torch.int64
        ),
        er_w=on_dev(er_w),
        es_idx=torch.arange(n, dtype=torch.int64, device=dev),
        es_ref=on_dev(grid.sdf.astype(np.float32)),
        es_w=on_dev(es_w),
        ea_pairs=on_dev(topo.ea_pairs, torch.int64),
        ea_w=on_dev(ea_w),
        lam=torch.zeros(4, dtype=torch.float32, device=dev),  # filled below
        images=images_level,
        pyr_scale=torch.tensor(pyr_scale, dtype=torch.float32, device=dev),
        voxel_size=torch.tensor(grid.voxel_size, dtype=torch.float32, device=dev),
    )

    # drop E_g residuals that evaluate invalid at the linearization point
    # (the reference evaluates each ShadingCost once before admitting it,
    # ``shading_cost.cpp:136-147``)
    with torch.no_grad():
        probe = asm._replace(lam=torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev))
        r_eg = eg_residuals(params, probe).cpu().numpy()
    eg_w = np.where(r_eg != 0.0, eg_w, 0.0).astype(np.float32)

    # per-type weight normalization ×1000 (``nls_solver.cpp:379-394``)
    lam = np.zeros(4, np.float32)
    for t, (lmbda, w_arr) in enumerate([(lambda_g, eg_w), (lambda_r, er_w), (lambda_s, es_w), (lambda_a, ea_w)]):
        s = float(w_arr.sum())
        lam[t] = (lmbda / s) * 1000.0 if (s > 0.0 and lmbda > 0.0) else 0.0
    asm = asm._replace(eg_w=on_dev(eg_w), lam=on_dev(lam))

    # parameter masks (``optimizer.cpp:285-361``)
    k = int(params.poses.shape[0])
    free_vox = in_shell & ring_ok
    pose_row = np.full((k, 6), 0.0 if fix_poses else 1.0, np.float32)
    intr_row = np.full((4,), 0.0 if fix_intrinsics else 1.0, np.float32)
    dist_row = np.full((5,), 0.0 if fix_distortion else 1.0, np.float32)
    if min_pose_obs > 0 and not fix_poses:
        # pose-observability gate, as in the device assembly: freeze the
        # pose blocks of starved keyframes
        nobs = np.bincount(eg_frame[eg_w > 0.0], minlength=k)
        pose_row = pose_row * (nobs >= min_pose_obs).astype(np.float32)[:, None]
        total_ok = np.float32(1.0 if nobs.sum() >= min_pose_obs else 0.0)
        intr_row = intr_row * total_ok
        dist_row = dist_row * total_ok
    masks = Masks(
        sdf=on_dev(free_vox.astype(np.float32)),
        albedo=on_dev((free_vox & (lambda_a >= 0.0)).astype(np.float32)),
        poses=on_dev(pose_row),
        intr=on_dev(intr_row),
        dist=on_dev(dist_row),
    )
    return asm, masks


def _ea_weights(
    grid: VoxelGrid, topo: LevelTopology, gate: np.ndarray, ring_ok: np.ndarray, lambda_a: float
) -> np.ndarray:
    """Active albedo pairs: at least one endpoint passes the residual gate
    with a valid ring (the reference emits a voxel's 6 edges when it
    processes the voxel, ``optimizer.cpp:255-276``); weight = chromaticity
    similarity."""
    if lambda_a <= 0.0:
        return np.zeros(len(topo.ea_pairs), np.float32)
    active_vox = gate & ring_ok
    i, j = topo.ea_pairs[:, 0], topo.ea_pairs[:, 1]
    active = active_vox[i] | active_vox[j]
    w = chroma_weights(grid.color, topo.ea_pairs)
    return np.where(active, w, 0.0).astype(np.float32)
