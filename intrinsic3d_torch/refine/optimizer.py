"""The refinement's outer step: device assembly followed by one damped-GN step.

Counterpart of `intrinsic3d_tpu/refine/optimizer.py::_fused_outer_step`, and
of the part of its `LevelPrep` that builds a level's layout, statics and
shift plans (`prepare_level`); the level loop around them (`optimize_level`,
frame-bucket planning, streamed linearization, background preparation) is
not part of this slice.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from intrinsic3d_torch.config import RefinementConfig
from intrinsic3d_torch.device import resolve_device
from intrinsic3d_torch.grid.blocks import BlockLayout, ShiftPlan
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid
from intrinsic3d_torch.refine.assembly import LevelTopology
from intrinsic3d_torch.refine.blockform import layout_plans, table_to_dense
from intrinsic3d_torch.refine.device_assembly import LevelStatic, build_level_static, device_assembly
from intrinsic3d_torch.refine.residuals import Params
from intrinsic3d_torch.refine.solver import gn_iteration


def fused_outer_step(
    st,
    sdf_plan,
    alb_plan,
    bparams,
    depths,
    images,
    pyr_scale,
    voxel_size,
    truncation,
    thres_shell,
    occlusion_distance,
    lambdas,
    mu,
    *,
    num_obs: int,
    width: int,
    height: int,
    fix_poses: bool,
    fix_intrinsics: bool,
    fix_distortion: bool,
    use_albedo: bool,
    lm_steps: int,
    cg_iters: int,
    schur_globals: bool = False,
    min_pose_obs: int = 0,
    cg_coeff_dtype: str = "bfloat16",
    cg_eta: float = 0.1,
    device="cuda",
):
    """One outer iteration of the refinement (``optimizer.cpp:119-173``):
    re-collect observations and rebuild the problem at the current
    parameters, then relinearize, solve and accept. `cg_coeff_dtype` and
    `cg_eta` pass through to `gn_iteration`.

    Returns (params', cost_before, cost_after, mu', num_tries)."""
    basm, bmasks = device_assembly(
        st,
        sdf_plan,
        alb_plan,
        bparams,
        depths,
        images,
        pyr_scale,
        voxel_size,
        truncation,
        thres_shell,
        occlusion_distance,
        lambdas,
        num_obs=num_obs,
        width=width,
        height=height,
        fix_poses=fix_poses,
        fix_intrinsics=fix_intrinsics,
        fix_distortion=fix_distortion,
        use_albedo=use_albedo,
        min_pose_obs=min_pose_obs,
        device=device,
    )
    return gn_iteration(
        bparams, basm, bmasks, mu, lm_steps, cg_iters,
        cg_coeff_dtype=cg_coeff_dtype, schur_globals=schur_globals, cg_eta=cg_eta, device=device,
    )


class LevelSetup(NamedTuple):
    """What every outer step of one (grid, pyramid) level shares."""

    layout: BlockLayout
    static: LevelStatic
    sdf_plan: ShiftPlan
    alb_plan: ShiftPlan
    params: Params  # block-dense start point ([nb+1, B³] voxel fields)
    scalars: Tuple[float, ...]  # pyr_scale, voxel_size, truncation, thres_shell, occlusion_distance
    lambdas: torch.Tensor  # [4] raw (λ_g, λ_r, λ_s, λ_a)
    assembly_kw: dict  # num_obs, width, height, fix_*, use_albedo
    device: torch.device

    def assemble(self, params: Params, depths, images):
        """`device_assembly` at `params`: (BlockAssembly, Masks)."""
        return device_assembly(
            self.static, self.sdf_plan, self.alb_plan, params, depths, images, *self.scalars,
            self.lambdas, **self.assembly_kw, device=self.device,
        )

    def outer_step(self, params: Params, depths, images, mu, **solver):
        """`fused_outer_step` at `params`; `solver` holds lm_steps, cg_iters
        and the optional solver settings."""
        return fused_outer_step(
            self.static, self.sdf_plan, self.alb_plan, params, depths, images, *self.scalars,
            self.lambdas, mu, **self.assembly_kw, **solver, device=self.device,
        )


def prepare_level(
    grid: VoxelGrid,
    topo: LevelTopology,
    voxel_sh: np.ndarray,
    params: Params,  # table-order sdf/albedo
    cfg: RefinementConfig,
    thres_shell: float,
    width: int,
    height: int,
    lambdas,
    pyr_scale: float = 1.0,
    device="cuda",
) -> LevelSetup:
    """Block layout, level statics, shift plans and block-dense parameters of
    one level, on `device`. `lambdas` are the raw (λ_g, λ_r, λ_s, λ_a)."""
    dev = resolve_device(device)
    layout = BlockLayout.build(grid)
    sdf_plan, alb_plan = layout_plans(layout, dev)
    return LevelSetup(
        layout=layout,
        static=build_level_static(layout, grid, topo, voxel_sh, device=dev),
        sdf_plan=sdf_plan,
        alb_plan=alb_plan,
        params=params._replace(
            sdf=table_to_dense(layout, params.sdf), albedo=table_to_dense(layout, params.albedo)
        ),
        scalars=(pyr_scale, grid.voxel_size, grid.truncation, thres_shell, cfg.occlusion_distance),
        lambdas=torch.as_tensor(lambdas, dtype=torch.float32, device=dev),
        assembly_kw=dict(
            num_obs=cfg.num_observations, width=width, height=height, fix_poses=cfg.fix_poses,
            fix_intrinsics=cfg.fix_intrinsics, fix_distortion=cfg.fix_distortion, use_albedo=True,
        ),
        device=dev,
    )
