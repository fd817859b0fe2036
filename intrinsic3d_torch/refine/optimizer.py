"""Per-level optimization driver: the reference's ``Optimizer::optimize``
loop (``optimizer.cpp:109-173``).

Counterpart of `intrinsic3d_tpu/refine/optimizer.py` on one device:
`optimize_level` runs a (grid, pyramid) level's outer iterations, each
re-collecting observations with the current parameters, rebuilding the
assembly with the scheduled λ_r/λ_s and taking one accepted damped
Gauss-Newton step (`fused_outer_step`); `plan_eg_layout` chooses the level's
E_g element layout by the JAX package's rules. `prepare_level` builds one
level's layout, statics and shift plans for a caller that steps it itself.

Only the dense frame-major layout runs: a plan that asks for frame buckets
or streamed linearization raises `NotImplementedError` (their element
transport is not ported yet). The JAX package's background `LevelPrep`, its
out-of-memory replan (which only leads to such plans) and the SPMD mesh
path are not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from intrinsic3d_torch.camera import Camera
from intrinsic3d_torch.config import RefinementConfig
from intrinsic3d_torch.device import resolve_device
from intrinsic3d_torch.grid.blocks import BlockLayout, ShiftPlan
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid
from intrinsic3d_torch.mathutil import compute_varying_lambda, pyramid_level_to_scale
from intrinsic3d_torch.refine.assembly import LevelTopology, level_topology
from intrinsic3d_torch.refine.blockform import (
    bucket_ladder_down,
    build_frame_buckets,
    layout_plans,
    params_from_block,
    table_to_dense,
)
from intrinsic3d_torch.refine.device_assembly import LevelStatic, build_level_static, device_assembly
from intrinsic3d_torch.refine.residuals import Params
from intrinsic3d_torch.refine.solver import gn_iteration

log = logging.getLogger("intrinsic3d")

# The card's peak bytes per dense E_g element through a level's outer steps
# (images, statics and solver temporaries included): the finest
# bench_pipeline level's peak, 36.42 GB over 10 × 5,728 × 512 = 29,327,360
# elements, on an NVIDIA H100 80GB HBM3 (chip_smoke.py's refinement phase;
# PERF.md). Smaller levels read more (1,268 B at 7.5 M, 1,373 B at 1.8 M
# elements: their fixed share is larger), but only large levels near the
# budget turn on it. The JAX package's 720 B is a TPU figure, not used here.
_EG_DENSE_BYTES_PER_ELEMENT = 1242
# The JAX package's calibrations of the bucketed and streamed layouts (TPU
# v5e). They only decide which non-dense plan a level would need, and such
# plans raise here until that transport is ported and measured on the card.
_EG_BUCKET_BYTES_PER_ELEMENT = 640
_EG_CHUNK_PERSIST_BYTES = 340
_EG_CHUNK_TRANSIENT_BYTES = 560
_EG_ASSEMBLY_BYTES = 340
# memory kept out of the element budget for everything that is not an E_g
# element temporary (images, persistent fields, non-element solver temps)
_EG_HBM_HEADROOM = 4.75e9


def eg_hbm_budget(device="cuda") -> float:
    """Memory budget of the dense E_g element fields:
    min(total − 4.75 GB, 0.7·total) of the device's memory — the card's from
    `torch.cuda.mem_get_info` (a failed query raises), the host's physical
    memory for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        total = float(torch.cuda.mem_get_info(dev)[1])
    else:
        total = float(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))
    return min(total - _EG_HBM_HEADROOM, 0.7 * total)


def plan_eg_layout(
    layout: BlockLayout,
    poses: np.ndarray,  # [K, 6]
    intr_level: np.ndarray,  # [4] fx fy cx cy at the pyramid level
    cfg: RefinementConfig,
    width: int,
    height: int,
    voxel_size: float,
    thres_shell: float,
    depths: Optional[np.ndarray],  # [K, H, W] level depth maps
    *,
    budget: Optional[float] = None,
    bytes_per_element: float = _EG_DENSE_BYTES_PER_ELEMENT,
    device="cuda",
) -> Tuple[Optional[np.ndarray], str, int]:
    """The E_g element layout of one (grid, pyramid) level, by the JAX
    package's rules (`intrinsic3d_tpu/refine/optimizer.py::plan_eg_layout`).

    Returns `(bmap, reason, eg_chunks)`: `bmap=None` keeps the dense
    frame-major `[K, nb, B³]` elements; a `bmap [K, NBc]` asks for frame
    buckets (`build_frame_buckets`), and `eg_chunks > 1` for the
    linearization streamed over frame chunks. Rules: bucketing wins on speed
    when the exact bucket layout halves the blocks; `frame_bucketing=
    "capped"` also tries a per-block frame cap for speed; bucketing is forced
    when the dense fields exceed `budget` (default `eg_hbm_budget(device)`),
    then streamed when even the exact buckets do not fit, then frame-capped
    and trimmed to the budget as a last resort. `bytes_per_element` is the
    dense layout's peak bytes per element."""
    if cfg.frame_bucketing == "never":
        return None, "dense (bucketing disabled)", 1
    if budget is None:
        budget = eg_hbm_budget(device)
    k = int(poses.shape[0])
    s = layout.block**3
    nb = layout.num_blocks
    use_depth_cull = depths is not None and cfg.occlusion_distance > 0.0
    common = dict(
        layout=layout,
        poses6=np.asarray(poses),
        intr4=np.asarray(intr_level, np.float64),
        width=width,
        height=height,
        voxel_size=voxel_size,
        depths=np.asarray(depths) if use_depth_cull else None,
        occlusion=cfg.occlusion_distance,
        depth_slack=0.05 + float(thres_shell),
    )
    fb = build_frame_buckets(**common, margin_px=0.15 * max(width, height))
    dense_bytes = k * nb * s * bytes_per_element
    win_speed = 2 * fb.shape[1] <= nb
    win_memory = dense_bytes > budget and fb.shape[1] < nb
    reason = "memory-forced" if (win_memory and not win_speed) else ("speed" if win_speed else "forced by config")
    cap = cfg.num_observations + 3
    if cfg.frame_bucketing == "capped" and not (win_speed or win_memory) and k > cap:
        fbc = build_frame_buckets(**common, margin_px=0.15 * max(width, height), max_frames_per_block=cap)
        if 2 * fbc.shape[1] <= nb:
            return fbc, f"speed, frame-capped at {cap} (opt-in)", 1
    if not (cfg.frame_bucketing == "always" or win_speed or win_memory):
        return None, "dense (full frame coverage, fits HBM)", 1
    bucket_bytes = k * fb.shape[1] * s * bytes_per_element
    if bucket_bytes > budget:
        # the exact buckets do not fit one-shot: stream them over frame
        # chunks when the persistent fields and the assembly fit
        el = k * fb.shape[1] * s
        persist = el * _EG_CHUNK_PERSIST_BYTES
        assembly = el * _EG_ASSEMBLY_BYTES
        per_frame_t = fb.shape[1] * s * _EG_CHUNK_TRANSIENT_BYTES
        if persist < budget and assembly <= budget:
            f_max = int((budget - persist) // per_frame_t)
            if f_max >= 1:
                chunks = -(-k // f_max)
                if chunks > 1:
                    return fb, reason + f", streamed in {chunks} chunks", chunks
        # last resort: per-block frame cap, halved margin and a hard
        # per-frame trim to the budget
        trim_bytes = min(bytes_per_element, _EG_BUCKET_BYTES_PER_ELEMENT)
        b_max = bucket_ladder_down(max(8, int(budget // (k * s * trim_bytes))))
        trim_stats: dict = {}
        fb = build_frame_buckets(
            **common,
            margin_px=0.08 * max(width, height),
            max_frames_per_block=min(cfg.num_observations + 1, k),
            max_blocks_per_frame=b_max,
            protect_cover=cfg.num_observations,
            stats=trim_stats,
        )
        reason += ", frame-capped"
        if trim_stats.get("trimmed_pairs", 0):
            reason += f", trimmed to {b_max} blocks/frame"
    return fb, reason, 1


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
    layout: Optional[BlockLayout] = None,
) -> LevelSetup:
    """Block layout (built unless given), level statics, shift plans and
    block-dense parameters of one level, on `device`. `lambdas` are the raw
    (λ_g, λ_r, λ_s, λ_a)."""
    dev = resolve_device(device)
    if layout is None:
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
            fix_intrinsics=cfg.fix_intrinsics, fix_distortion=cfg.fix_distortion, use_albedo=cfg.lambda_a >= 0.0,
        ),
        device=dev,
    )


@dataclasses.dataclass
class OptimizeStats:
    """Per-iteration record of one level (the JAX package's fields first),
    plus the level's plan and sizes, its setup and iteration seconds (host
    clock; every iteration ends on a host read of its costs) and, on the
    card, its peak allocated bytes."""

    costs_before: list
    costs_after: list
    tries: list
    mus: list = dataclasses.field(default_factory=list)
    reason: str = ""
    num_blocks: int = 0
    elements: int = 0
    setup_seconds: float = 0.0
    iter_seconds: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0


def optimize_level(
    grid: VoxelGrid,
    topo: Optional[LevelTopology],
    params: Params,  # table-order sdf/albedo on `device`
    cfg: RefinementConfig,
    base_cam: Camera,
    depths_level: torch.Tensor,  # [K, H, W]
    images_level: torch.Tensor,  # [K, H, W] intensity
    voxel_sh: np.ndarray,  # [N, 9]
    thres_shell: float,
    rgbd_level: int,
    mu0: float = 1e-4,
    cg_iters: int = 12,
    budget: Optional[float] = None,
    cg_coeff_dtype: str = "bfloat16",
    cg_eta: float = 0.1,
    device="cuda",
) -> Tuple[Params, float, OptimizeStats]:
    """Run `cfg.iterations` relinearized GN steps of one (grid, pyramid)
    level on `device`; returns the updated table-order params, the final
    damping (the next level's start, the reference's trust-region warm
    start) and the level's `OptimizeStats`.

    The level runs on the block-dense layout with the per-iteration device
    assembly; λ_r and λ_s follow `compute_varying_lambda` over the
    iterations. `plan_eg_layout` decides the layout against `budget`
    (default: `eg_hbm_budget(device)`); a plan for frame buckets or streamed
    linearization raises `NotImplementedError` naming its reason, and an
    out-of-memory error propagates. `cg_coeff_dtype` and `cg_eta` pass
    through to `gn_iteration` (the JAX level loop runs its defaults). On the
    card the peak-memory counter is reset at the start, so `peak_bytes` is
    this level's peak. `base_cam` is unused, as in the JAX block path."""
    del base_cam
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    pyr_scale = pyramid_level_to_scale(rgbd_level)
    h, w = int(depths_level.shape[1]), int(depths_level.shape[2])
    stats = OptimizeStats([], [], [])
    t0 = time.perf_counter()
    layout = BlockLayout.build(grid)
    fb, reason, eg_chunks = plan_eg_layout(
        layout,
        params.poses.detach().cpu().numpy(),
        params.intr.detach().cpu().numpy().astype(np.float64) * pyr_scale,
        cfg,
        w,
        h,
        grid.voxel_size,
        thres_shell,
        depths_level.cpu().numpy() if cfg.occlusion_distance > 0.0 else None,
        budget=budget,
        device=dev,
    )
    if fb is not None or eg_chunks > 1:
        raise NotImplementedError(
            f"E_g layout plan '{reason}' ({'dense' if fb is None else f'{fb.shape[1]} blocks/frame'}, "
            f"{eg_chunks} chunks) needs frame buckets or streamed linearization, which the port does not run yet"
        )
    level = prepare_level(
        grid, level_topology(grid) if topo is None else topo, voxel_sh, params, cfg, thres_shell, w, h,
        lambdas=(cfg.lambda_g, cfg.lambda_r0, cfg.lambda_s0, cfg.lambda_a), pyr_scale=pyr_scale, device=dev,
        layout=layout,
    )
    stats.reason = reason
    stats.num_blocks = layout.num_blocks
    stats.elements = int(params.poses.shape[0]) * layout.num_blocks * layout.block**3
    stats.setup_seconds = time.perf_counter() - t0
    log.info(
        "   level setup: %.2fs (%d blocks, %d voxels, %d elements, %s)",
        stats.setup_seconds, layout.num_blocks, grid.num_voxels, stats.elements, reason,
    )

    bparams, mu = level.params, torch.tensor(mu0, dtype=torch.float32, device=dev)
    solver = dict(
        lm_steps=cfg.lm_steps, cg_iters=cg_iters, schur_globals=cfg.schur_globals, min_pose_obs=cfg.min_pose_obs,
        cg_coeff_dtype=cg_coeff_dtype, cg_eta=cg_eta,
    )
    for itr in range(cfg.iterations):
        t0 = time.perf_counter()
        lambda_r = compute_varying_lambda(itr, cfg.iterations, cfg.lambda_r0, cfg.lambda_r1)
        lambda_s = compute_varying_lambda(itr, cfg.iterations, cfg.lambda_s0, cfg.lambda_s1)
        lambdas = torch.tensor([cfg.lambda_g, lambda_r, lambda_s, cfg.lambda_a], dtype=torch.float32, device=dev)
        bparams, cost0, cost1, mu, tries = level._replace(lambdas=lambdas).outer_step(
            bparams, depths_level, images_level, mu, **solver
        )
        stats.costs_before.append(float(cost0))
        stats.costs_after.append(float(cost1))
        stats.tries.append(int(tries))
        stats.mus.append(float(mu))
        stats.iter_seconds.append(time.perf_counter() - t0)
        log.info(
            "   iter %d: cost %.6e -> %.6e (lm tries %d, mu %.2e)",
            itr, stats.costs_before[-1], stats.costs_after[-1], stats.tries[-1], stats.mus[-1],
        )
    if dev.type == "cuda":
        stats.peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    return params_from_block(layout, bparams), float(mu), stats
