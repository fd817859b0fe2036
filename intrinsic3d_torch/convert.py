"""Build the port's objects from numpy arrays of the JAX package.

The parity tests take the JAX package's arrays with `np.asarray` and hand
them here, so both sides start from identical inputs. Nothing in this module
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from intrinsic3d_torch.device import resolve_device
from intrinsic3d_torch.grid.blocks import BlockLayout
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid, pack_coords
from intrinsic3d_torch.refine.blockform import BlockAssembly, layout_plans
from intrinsic3d_torch.refine.residuals import Assembly, Params
from intrinsic3d_torch.refine.solver import Masks


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=resolve_device(device))  # a writable copy


def params_from_numpy(sdf, albedo, poses, intr, dist, device="cuda") -> Params:
    """Port `Params` (float32) from numpy fields (table or block-dense)."""
    return Params(*(_t(a, device) for a in (sdf, albedo, poses, intr, dist)))


def masks_from_numpy(sdf, albedo, poses, intr, dist, device="cuda") -> Masks:
    """Port `Masks` (float32 0/1) from numpy fields."""
    return Masks(*(_t(a, device) for a in (sdf, albedo, poses, intr, dist)))


def grid_from_numpy(voxel_size, coords, sdf, weight, color, albedo=None, sdf_refined=None) -> VoxelGrid:
    """Port `VoxelGrid` from a key-sorted voxel table's numpy fields."""
    coords = np.ascontiguousarray(np.asarray(coords, np.int32))
    opt = lambda a: None if a is None else np.asarray(a, np.float32).copy()  # noqa: E731
    return VoxelGrid(
        voxel_size=float(voxel_size),
        coords=coords,
        keys=pack_coords(coords),
        sdf=np.asarray(sdf, np.float32).copy(),
        weight=np.asarray(weight, np.float32).copy(),
        color=np.asarray(color, np.float32).copy(),
        albedo=opt(albedo),
        sdf_refined=opt(sdf_refined),
    )


def block_assembly_from_numpy(
    layout: BlockLayout,
    eg_w, eg_sh, eg_vpos, er_w, es_ref, es_w, ea_w, lam, images, pyr_scale, voxel_size,
    bmap=None,
    device="cuda",
) -> BlockAssembly:
    """Port `BlockAssembly` from the fields of a JAX `BlockAssembly` (dense,
    or frame-bucketed with `bmap`), with the port's own gather-form shift
    plans rebuilt from `layout`."""
    sdf_plan, alb_plan = layout_plans(layout, device)
    return BlockAssembly(
        eg_w=_t(eg_w, device),
        eg_sh=_t(eg_sh, device),
        eg_vpos=_t(eg_vpos, device, torch.int32),
        sdf_plan=sdf_plan,
        alb_plan=alb_plan,
        er_w=_t(er_w, device),
        es_ref=_t(es_ref, device),
        es_w=_t(es_w, device),
        ea_w=_t(ea_w, device),
        lam=_t(lam, device),
        images=_t(images, device),
        pyr_scale=_t(pyr_scale, device),
        voxel_size=_t(voxel_size, device),
        bmap=None if bmap is None else _t(bmap, device, torch.int64),
    )


def assembly_from_numpy(
    eg_sdf10_idx, eg_alb4_idx, eg_frame, eg_w, eg_sh, eg_vpos, er_idx, er_w, es_idx, es_ref, es_w, ea_pairs, ea_w,
    lam, images, pyr_scale, voxel_size, eg_onehot=None, device="cuda",
) -> Assembly:
    """Port flat-table `Assembly` from the fields of a JAX `Assembly`
    (`Assembly(**{k: np.asarray(v) ...})`-style keywords). The JAX
    `eg_onehot` (a TPU contraction of the pose gather) is accepted and
    dropped; index fields become int64."""
    del eg_onehot
    i64 = torch.int64
    return Assembly(
        eg_sdf10_idx=_t(eg_sdf10_idx, device, i64),
        eg_alb4_idx=_t(eg_alb4_idx, device, i64),
        eg_frame=_t(eg_frame, device, i64),
        eg_w=_t(eg_w, device),
        eg_sh=_t(eg_sh, device),
        eg_vpos=_t(eg_vpos, device, torch.int32),
        er_idx=_t(er_idx, device, i64),
        er_w=_t(er_w, device),
        es_idx=_t(es_idx, device, i64),
        es_ref=_t(es_ref, device),
        es_w=_t(es_w, device),
        ea_pairs=_t(ea_pairs, device, i64),
        ea_w=_t(ea_w, device),
        lam=_t(lam, device),
        images=_t(images, device),
        pyr_scale=_t(pyr_scale, device),
        voxel_size=_t(voxel_size, device),
    )
