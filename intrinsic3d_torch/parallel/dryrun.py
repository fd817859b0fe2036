"""Rank launcher and the multi-device dry run.

    python -m intrinsic3d_torch.parallel.dryrun --world-size N [--backend gloo|nccl] [--device cuda|cpu]
    torchrun --nproc-per-node N -m intrinsic3d_torch.parallel.dryrun --backend nccl

The port's twin of `__graft_entry__.dryrun_multichip`: on a mesh of N ranks
it checks (1) the halo'd shift plans against the single-device ones, then
runs (2) one spatially sharded GN step (`spmd_gn_iteration`, joint and
Schur-eliminated), (3) the production level loop `optimize_level(mesh=)`
with dense and frame-bucketed elements, (4) the sharded SVSH estimate and
recolor sweep, (5) the voxel-sharded `FusionVolume(mesh=)` and (6) a
two-grid-level `Intrinsic3D(mesh=)` refinement, each against the port's
single-device path on the same inputs, and rank 0 prints one line each.
Without `torchrun` the command spawns its N ranks itself (`launch`); under
`torchrun` each process is one rank (`env://` rendezvous).

`launch` starts ranks in fresh interpreters (the `spawn` start method), so
a rank imports only torch and this package. Every rank task here takes the
rank's `Mesh` and numpy inputs and returns numpy results; the tests feed
them the JAX package's inputs.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from intrinsic3d_torch.parallel.sharding import Mesh, close_mesh, init_mesh

DEFAULT_TIMEOUT_S = 900.0


# ---------------------------------------------------------------------------
# Launching ranks
# ---------------------------------------------------------------------------


def _rank_main(rank, task, world_size, backend, device, init_method, args, out_dir):
    if torch.device(device).type == "cpu":
        # ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    mesh = init_mesh(world_size, rank, backend=backend, init_method=init_method, device=device)
    try:
        result = task(mesh, *args)
    finally:
        close_mesh(mesh)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def launch(
    task: Callable,
    world_size: int,
    *,
    backend: str,
    device: str,
    init_method: Optional[str] = None,
    args: Sequence = (),
    timeout: float = DEFAULT_TIMEOUT_S,
) -> List:
    """Run `task(mesh, *args)` on `world_size` spawned ranks and return
    every rank's result, in rank order. `task` must be importable by name
    (a module-level function). `init_method` defaults to a `file://`
    rendezvous in a fresh temporary directory. A rank that raises fails the
    launch with its traceback; ranks still running after `timeout` seconds
    are terminated and the launch raises `TimeoutError`.

    The native host library and, for CUDA ranks, the kernels are built here
    before the ranks start, so no two ranks build them at once."""
    import torch.multiprocessing as mp

    from intrinsic3d_torch import native
    from intrinsic3d_torch.ops import build

    native.get_lib()
    if torch.device(device).type == "cuda":
        build.build_all()
    with tempfile.TemporaryDirectory(prefix="i3d_ranks_") as tmp:
        init_method = init_method or f"file://{tmp}/rendezvous"
        ctx = mp.start_processes(
            _rank_main,
            args=(task, world_size, backend, device, init_method, tuple(args), tmp),
            nprocs=world_size,
            join=False,
            start_method="spawn",
        )
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{world_size} ranks of {task.__name__} still running after {timeout:.0f}s")
        out = []
        for r in range(world_size):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


# ---------------------------------------------------------------------------
# Inputs as numpy dicts (made by the port here, by the JAX package in tests)
# ---------------------------------------------------------------------------


def _grid(d: dict):
    from intrinsic3d_torch.convert import grid_from_numpy

    return grid_from_numpy(d["voxel_size"], d["coords"], d["sdf"], d["weight"], d["color"],
                           albedo=d.get("albedo"), sdf_refined=d.get("sdf_refined"))


def _grid_dict(grid) -> dict:
    out = dict(voxel_size=grid.voxel_size, coords=grid.coords, sdf=grid.sdf, weight=grid.weight, color=grid.color)
    if grid.albedo is not None:
        out.update(albedo=grid.albedo, sdf_refined=grid.sdf_refined)
    return out


def _cam(d: dict):
    from intrinsic3d_torch.camera import Camera

    return Camera.create(d["fx"], d["fy"], d["cx"], d["cy"], d["width"], d["height"])


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def small_problem(voxel_size=0.015, image_size=(64, 48), num_frames=2, num_obs=2):
    """`__graft_entry__._small_problem` in the port: the perturbed sphere
    problem of the JAX dry run, built on the CPU."""
    from intrinsic3d_torch.config import RefinementConfig
    from intrinsic3d_torch.synthetic import build_sphere_problem

    cfg = RefinementConfig(num_observations=num_obs, occlusion_distance=0.04, fix_poses=False,
                           fix_intrinsics=False, fix_distortion=False)
    return build_sphere_problem(voxel_size=voxel_size, image_size=image_size, num_frames=num_frames,
                                num_observations=num_obs, cfg=cfg, perturb_sdf=0.002, perturb_albedo=0.05,
                                device="cpu")


def block_problem_inputs(prob, blocks_multiple: int, bucket: bool = False) -> dict:
    """The global block problem of a `SphereProblem` (`to_block_problem` of
    its flat assembly; frame-bucketed with `bucket`) as numpy."""
    from intrinsic3d_torch.grid.blocks import BlockLayout
    from intrinsic3d_torch.refine.blockform import to_block_problem

    asm, masks = prob.assemble()
    layout = BlockLayout.build(prob.grid, blocks_multiple=blocks_multiple)
    bp, basm, bm = to_block_problem(layout, prob.topo.coords, asm, masks, prob.params, bucket=bucket, device="cpu")
    fields = ("eg_w", "eg_sh", "eg_vpos", "er_w", "es_ref", "es_w", "ea_w", "lam", "images", "pyr_scale",
              "voxel_size", "bmap")
    return dict(
        grid=_grid_dict(prob.grid), blocks_multiple=blocks_multiple,
        bp=[_np(a) for a in bp], bm=[_np(a) for a in bm],
        basm={k: None if getattr(basm, k) is None else _np(getattr(basm, k)) for k in fields},
    )


def level_inputs(prob, cfg_overrides: Optional[dict] = None) -> dict:
    """One level's `optimize_level` and stage inputs of a `SphereProblem`
    as numpy (the grid's refined fields set to the start point)."""
    grid = prob.grid
    grid.sdf_refined = _np(prob.params.sdf).astype(np.float32)
    grid.albedo = _np(prob.params.albedo).astype(np.float32)
    cfg = dataclasses.asdict(prob.cfg)
    cfg.update(cfg_overrides or {})
    images = _np(prob.images)
    return dict(
        grid=_grid_dict(grid), params=[_np(a) for a in prob.params], cfg=cfg,
        cam=dict(fx=float(prob.cam.fx), fy=float(prob.cam.fy), cx=float(prob.cam.cx), cy=float(prob.cam.cy),
                 width=int(prob.cam.width), height=int(prob.cam.height)),
        depths=_np(prob.depths), images=images, voxel_sh=np.asarray(prob.voxel_sh, np.float32),
        thres_shell=float(prob.thres_shell),
        colors_u8=np.clip(np.stack([images] * 3, axis=-1) * 255.0, 0, 255).astype(np.uint8),
    )


def sphere_scene() -> dict:
    """The three-view sphere capture of the JAX mesh-level-loop test
    (`tests/test_spmd_stages.py`), rendered by the port, as numpy."""
    from intrinsic3d_torch.synthetic import (
        DEFAULT_CENTER,
        DEFAULT_LIGHT,
        DEFAULT_RADIUS,
        look_at_pose,
        render_shading_image,
    )

    cam = dict(fx=70.0, fy=70.0, cx=31.5, cy=23.5, width=64, height=48)
    eyes = [[0.0, 0.0, 0.0], [0.4, 0.05, 0.2], [-0.35, -0.1, 0.25]]
    poses = [look_at_pose(e, DEFAULT_CENTER) for e in eyes]
    colors, depths = [], []
    for T in poses:
        img, depth = render_shading_image(_cam(cam), T, DEFAULT_CENTER, DEFAULT_RADIUS, DEFAULT_LIGHT)
        colors.append(np.stack([np.clip(img, 0, 1)] * 3, axis=-1).astype(np.float32))
        depths.append(np.asarray(depth, np.float32))
    return dict(cam=cam, colors=np.stack(colors), depths=np.stack(depths), poses=np.stack(poses),
                depth_min=0.1, depth_max=2.0)


# ---------------------------------------------------------------------------
# Rank tasks
# ---------------------------------------------------------------------------


def _block_problem(bprob: dict, dev):
    from intrinsic3d_torch.convert import block_assembly_from_numpy, masks_from_numpy, params_from_numpy
    from intrinsic3d_torch.grid.blocks import BlockLayout

    layout = BlockLayout.build(_grid(bprob["grid"]), blocks_multiple=bprob["blocks_multiple"])
    bp = params_from_numpy(*bprob["bp"], device=dev)
    basm = block_assembly_from_numpy(layout, **bprob["basm"], device=dev)
    bm = masks_from_numpy(*bprob["bm"], device=dev)
    return layout, bp, basm, bm


def run_tasks(mesh: Mesh, calls: Sequence) -> dict:
    """Run `(name, task, args, kwargs)` calls in order on this rank:
    `{name: task(mesh, *args, **kwargs)}` (one launch for many tasks)."""
    return {name: task(mesh, *args, **kw) for name, task, args, kw in calls}


def halo_task(mesh: Mesh, bprob: dict, seed: int = 0) -> dict:
    """The rank's `ShardedPlan`s against the single-device `ShiftPlan`s of
    the same layout on seeded float64 fields: per plan, the largest
    difference of `apply` and of `apply_transpose` (gathered over the
    ranks) and both sides of the adjoint identity ⟨Ax, y⟩ = ⟨x, Aᵀy⟩."""
    from intrinsic3d_torch.grid.blocks import BlockLayout, pad_flat
    from intrinsic3d_torch.parallel.spmd import make_spmd_context
    from intrinsic3d_torch.parallel.staging import to_global
    from intrinsic3d_torch.refine.blockform import layout_plans

    dev = mesh.device
    layout = BlockLayout.build(_grid(bprob["grid"]), blocks_multiple=bprob["blocks_multiple"])
    ctx = make_spmd_context(layout, mesh)
    lo, hi = ctx.brick()
    nb, s = layout.num_blocks, layout.block**3
    rng = np.random.default_rng(seed)
    out = {}
    for name, plan, plan_s in zip(("sdf", "albedo"), layout_plans(layout, "cpu"), (ctx.sdf_plan_s, ctx.alb_plan_s)):
        x = torch.as_tensor(rng.standard_normal((nb, s)))
        y = torch.as_tensor(rng.standard_normal((len(plan.offsets), nb, s)))
        ax = to_global(mesh, plan_s.apply(pad_flat(x[lo:hi].to(dev))), dim=1).cpu()
        aty_loc = plan_s.apply_transpose(y[:, lo:hi].contiguous().to(dev))
        aty = to_global(mesh, aty_loc[:-1]).cpu()
        lhs = mesh.all_reduce(torch.sum(ax[:, lo:hi].to(dev) * y[:, lo:hi].to(dev)))
        rhs = mesh.all_reduce(torch.sum(x[lo:hi].to(dev) * aty_loc[:-1]))
        out[name] = dict(
            apply_err=float(torch.max(torch.abs(ax - plan.apply(pad_flat(x))))),
            transpose_err=float(torch.max(torch.abs(aty - plan.apply_transpose(y)[:nb]))),
            adjoint=(float(lhs), float(rhs)),
        )
    return out


def spmd_step_task(mesh: Mesh, bprob: dict, schur=False, lm_steps: int = 3, cg_iters: int = 4,
                   cg_coeff_dtype: str = "bfloat16") -> dict:
    """One `spmd_gn_iteration` of the global block problem `bprob`, and the
    single-device `gn_iteration` of the same problem on the rank's device:
    costs, tries, μ and the gathered params of both, with the rank's brick
    and halo sizes and the collectives the sharded step called."""
    from intrinsic3d_torch.parallel.spmd import make_spmd_context, spmd_gn_iteration
    from intrinsic3d_torch.refine.solver import gn_iteration

    layout, bp, basm, bm = _block_problem(bprob, mesh.device)
    ctx = make_spmd_context(layout, mesh)
    kw = dict(lm_steps=lm_steps, cg_iters=cg_iters, cg_coeff_dtype=cg_coeff_dtype, schur_globals=schur)
    mesh.stats.reset()
    sp = spmd_gn_iteration(bp, basm, bm, 1e-4, layout, mesh, ctx=ctx, **kw)
    calls = dict(mesh.stats.calls)
    one = gn_iteration(bp, basm, bm, 1e-4, device=mesh.device, **kw)

    def pack(out):
        p, c0, c1, mu, tries = out
        return dict(params=[_np(a) for a in p], cost0=float(c0), cost1=float(c1), mu=float(mu), tries=int(tries))

    return dict(spmd=pack(sp), single=pack(one), m=ctx.m, hs=tuple(ctx.halo.hs), shifts=tuple(ctx.halo.shifts),
                collectives=calls)


def _level_args(lp: dict, dev):
    """(grid, table params on `dev`, RefinementConfig) of a level dict."""
    from intrinsic3d_torch.config import RefinementConfig
    from intrinsic3d_torch.convert import params_from_numpy

    return _grid(lp["grid"]), params_from_numpy(*lp["params"], device=dev), RefinementConfig(**lp["cfg"])


def pipeline_task(mesh: Mesh, lp: dict, modes: Sequence[str] = ("never", "always"), iterations: int = 2,
                  lm_steps: int = 4, cg_iters: int = 4, single: bool = True, budget: Optional[float] = None) -> dict:
    """`optimize_level(mesh=)` of the level `lp` for each frame-bucketing
    mode (the JAX dry run's joint-solver settings), and with `single` the
    single-device `optimize_level` of the same inputs, both planned against
    `budget` (default: each one's own): per mode the costs, tries, plan and
    the final table params of both."""
    from intrinsic3d_torch.refine.optimizer import optimize_level

    grid, params, cfg = _level_args(lp, mesh.device)
    dev = mesh.device
    depths = torch.as_tensor(lp["depths"], device=dev)
    images = torch.as_tensor(lp["images"], device=dev)
    out = {}
    for mode in modes:
        cfgl = dataclasses.replace(cfg, iterations=iterations, lm_steps=lm_steps, frame_bucketing=mode, lambda_r0=20.0,
                          lambda_r1=20.0, lambda_s0=20.0, lambda_s1=20.0, schur_globals=False)
        args = (grid, None, params, cfgl, None, depths, images, lp["voxel_sh"], lp["thres_shell"], 0)
        runs = {"mesh": optimize_level(*args, cg_iters=cg_iters, budget=budget, mesh=mesh)}
        if single:
            runs["single"] = optimize_level(*args, cg_iters=cg_iters, budget=budget, device=dev)
        out[mode] = {
            k: dict(costs_before=st.costs_before, costs_after=st.costs_after, tries=st.tries,
                    params=[_np(a) for a in p], bucket_blocks=st.bucket_blocks, eg_chunks=st.eg_chunks,
                    brick_rows=st.brick_rows, halo_rows=st.halo_rows)
            for k, (p, _, st) in runs.items()
        }
    return out


def stages_task(mesh: Mesh, lp: dict, subvolume_size: float = 0.12, lambda_reg: float = 10.0,
                num_best: int = 2) -> dict:
    """The sharded SVSH estimate (coefficients, per-voxel SH in table order)
    and recolor sweep (colors, flags in table order) of the level `lp`, and
    the single-device `estimate_svsh` of the same grid; with the brick's
    placement fractions."""
    from intrinsic3d_torch.grid.blocks import BlockLayout
    from intrinsic3d_torch.lighting.svsh import estimate_svsh
    from intrinsic3d_torch.parallel.spmd import make_spmd_context
    from intrinsic3d_torch.parallel.spmd_stages import SpmdStages, place_block_params, shard_fraction
    from intrinsic3d_torch.parallel.staging import to_global

    grid, params, cfg = _level_args(lp, mesh.device)
    dev = mesh.device
    layout = BlockLayout.build(grid, blocks_multiple=max(8, mesh.size))
    ctx = make_spmd_context(layout, mesh)
    stages = SpmdStages.build(
        mesh, ctx, layout, grid, _cam(lp["cam"]), torch.as_tensor(lp["depths"], device=dev),
        torch.as_tensor(lp["colors_u8"], device=dev), subvolume_size, num_best, cfg.occlusion_distance,
    )
    bp_s = place_block_params(mesh, layout, params)
    colors = stages.stage_colors(grid.color)
    svsh, vox_sh = stages.svsh(bp_s, colors, lambda_reg, lp["thres_shell"])
    slot = torch.as_tensor(layout.vox_slot, device=dev)
    vox_sh_tab = to_global(mesh, vox_sh, dim=1).reshape(9, -1)[:, slot].T
    new_bd, has_bd = stages.recolor(bp_s, colors)
    cols, has = stages.colors_to_table(new_bd, has_bd)
    ref = estimate_svsh(grid, subvolume_size, lambda_reg, lp["thres_shell"], device=dev)
    nb, s = layout.num_blocks, layout.block**3
    return dict(
        coeffs=svsh.coeffs, num_subvolumes=svsh.subvolumes.count, vox_sh=_np(vox_sh_tab), colors=cols, has=has,
        single_coeffs=ref.coeffs,
        fractions=dict(sdf=shard_fraction(bp_s.sdf[:-1], (nb, s)), valid=shard_fraction(stages.valid, (nb, s)),
                       vpos=shard_fraction(stages.vpos, (3, nb, s)), subvol=shard_fraction(stages.subvol, (nb, s))),
    )


def _fused_scene(scene: dict, voxel_size: float, dev):
    """TSDF fusion of `scene` on `dev` followed by the distance-transform
    correction and the invalid-voxel clearing (the JAX test's fused input)."""
    from intrinsic3d_torch.grid import algorithms as alg

    vol = _fusion_volume(scene, voxel_size, dev, None)
    return alg.clear_invalid_voxels(alg.correct_sdf(vol.finalize(), device=dev))


def _fusion_volume(scene: dict, voxel_size: float, dev, mesh):
    from intrinsic3d_torch.grid.fusion import FusionVolume, compute_scene_voxel_bounds

    cam = _cam(scene["cam"])
    lo, hi = scene["depth_min"], scene["depth_max"]
    vlo, vhi = compute_scene_voxel_bounds(cam, list(scene["poses"]), lo, hi, voxel_size)
    vol = FusionVolume(cam, cam, voxel_size, vlo, vhi, lo, hi, device=dev, mesh=mesh)
    vol.allocate_batch(scene["depths"], scene["poses"])
    vol.build_grid()
    vol.integrate_batch(scene["depths"], scene["colors"], scene["poses"])
    return vol


def fusion_task(mesh: Mesh, scene: dict, voxel_size: float = 0.02) -> dict:
    """`FusionVolume(mesh=)` of `scene` and the single-device fusion of the
    same frames on the rank's device: sdf, weight, color of both."""
    got = _fusion_volume(scene, voxel_size, mesh.device, mesh).finalize()
    ref = _fusion_volume(scene, voxel_size, mesh.device, None).finalize()
    return {k: dict(sdf=g.sdf, weight=g.weight, color=g.color, coords=g.coords)
            for k, g in (("mesh", got), ("single", ref))}


def mesh_loop_task(mesh: Mesh, scene: dict, cfg: dict, voxel_size: float = 0.03, cg_iters: int = 6,
                   single: bool = True, prefetch: bool = True) -> dict:
    """`Intrinsic3D(mesh=).refine` of the scene fused at `voxel_size`, and
    with `single` the single-device engine's refinement of the same fused
    grid, both with the level preps on or off (`prefetch`): the refined
    fields of both, the mesh run's placement records and each level's
    costs."""
    from intrinsic3d_torch.config import RefinementConfig
    from intrinsic3d_torch.io.memory_sensor import MemorySensor
    from intrinsic3d_torch.refine.intrinsic3d import Intrinsic3D

    dev = mesh.device
    fused = _fused_scene(scene, voxel_size, dev)
    rcfg = RefinementConfig(**cfg)
    keyframes = list(range(len(scene["poses"])))

    def run(with_mesh):
        cam = _cam(scene["cam"])
        sensor = MemorySensor(cam, cam, list(scene["colors"]), list(scene["depths"]), list(scene["poses"]),
                              scene["depth_min"], scene["depth_max"])
        engine = Intrinsic3D(rcfg, sensor, keyframes, cg_iters=cg_iters, device=dev,
                             mesh=mesh if with_mesh else None, prefetch=prefetch)
        levels = []
        engine.add_callback(lambda info: levels.append(dict(
            level=f"g{info.grid_level}p{info.pyramid_level}", costs_before=info.stats.costs_before,
            costs_after=info.stats.costs_after)))
        g = engine.refine(fused.clone())
        return engine, dict(sdf_refined=g.sdf_refined, albedo=g.albedo, color=g.color, coords=g.coords,
                            voxel_size=g.voxel_size, levels=levels)

    engine, out = run(True)
    res = dict(mesh=out, placements=engine.mesh_placements)
    if single:
        res["single"] = run(False)[1]
    return res


def refinement_task(mesh: Mesh, fused, keyframes: Sequence[int], starts: Sequence = ()) -> dict:
    """`Intrinsic3D(mesh=).refine` of `fused` at bench_pipeline.py's scale:
    the orbit capture of `synthetic.PIPELINE_DATASET` rendered on the rank,
    `PIPELINE_REFINEMENT` with `PIPELINE_CG_ITERS`, the kernels' launch
    counters and the mesh's collective counters zeroed just before and read
    just after. Then two outer iterations of `optimize_level(mesh=)` from
    each level start in `starts`: [(grid, params as numpy, depths, images,
    voxel_sh, thres_shell, rgbd_level, mu0)] of a single-device run.

    Returns per level its plan, brick and halo rows, costs, tries,
    iteration seconds, peak bytes and the collectives so far; the launches,
    phase seconds and collectives of the whole refinement; the refined SDF's
    distance to the analytic sphere (`synthetic.refined_sdf_error`); the
    placement records; and each start's costs and tries."""
    from intrinsic3d_torch.ops import build
    from intrinsic3d_torch.refine.intrinsic3d import Intrinsic3D
    from intrinsic3d_torch.refine.optimizer import optimize_level
    from intrinsic3d_torch.refine.residuals import Params
    from intrinsic3d_torch.synthetic import (
        PIPELINE_CG_ITERS,
        PIPELINE_DATASET,
        PIPELINE_REFINEMENT,
        build_orbit_dataset,
        refined_sdf_error,
    )

    dev = mesh.device
    cuda = dev.type == "cuda"
    sensor = build_orbit_dataset(**PIPELINE_DATASET)
    levels, stats = [], {}

    def on_level(info):
        calls, secs = mesh.stats.total()
        st = info.stats
        levels.append(dict(level=f"g{info.grid_level}p{info.pyramid_level}", voxels=info.grid.num_voxels,
                           blocks=st.num_blocks, brick_rows=st.brick_rows, halo_rows=list(st.halo_rows),
                           elements=st.elements, eg_chunks=st.eg_chunks, reason=st.reason,
                           costs_before=st.costs_before, costs_after=st.costs_after, tries=st.tries,
                           iter_s=st.iter_seconds, peak_bytes=st.peak_bytes, collective_calls=calls,
                           collective_s=secs))

    if cuda:
        torch.cuda.synchronize(dev)
    build.reset_launches()
    mesh.stats.reset()
    t0 = time.perf_counter()
    engine = Intrinsic3D(PIPELINE_REFINEMENT, sensor, keyframes, cg_iters=PIPELINE_CG_ITERS, stats=stats,
                         mesh=mesh)
    engine.add_callback(on_level)
    refined = engine.refine(fused, stats=stats)
    if cuda:
        torch.cuda.synchronize(dev)
    total_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    calls, secs = mesh.stats.total()
    med, p90, med0, n_shell = refined_sdf_error(refined, PIPELINE_DATASET["center"], PIPELINE_DATASET["radius"])
    out = dict(rank=mesh.rank, levels=levels, launches=launches, total_s=total_s, phases=stats,
               collectives=dict(calls=dict(mesh.stats.calls), seconds=dict(mesh.stats.seconds), total_calls=calls,
                                total_s=secs),
               sdf=dict(median=med, p90=p90, unrefined_median=med0, shell_voxels=n_shell),
               voxel_size=refined.voxel_size, placements=engine.mesh_placements)
    del engine, refined
    if cuda:
        torch.cuda.empty_cache()

    cfg = dataclasses.replace(PIPELINE_REFINEMENT, iterations=2)
    out["from_starts"] = []
    for grid, params, depths, images, voxel_sh, thres_shell, rgbd_level, mu0 in starts:
        p = Params(*(torch.as_tensor(a, device=dev) for a in params))
        _, _, st = optimize_level(grid, None, p, cfg, None, torch.as_tensor(depths, device=dev),
                                  torch.as_tensor(images, device=dev), voxel_sh, thres_shell, rgbd_level, mu0=mu0,
                                  cg_iters=PIPELINE_CG_ITERS, mesh=mesh)
        out["from_starts"].append(dict(costs_before=st.costs_before, costs_after=st.costs_after, tries=st.tries))
    return out


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

MESH_LOOP_CFG = dict(
    num_grid_levels=2, num_rgbd_levels=1, iterations=2, lm_steps=4, num_observations=2, occlusion_distance=0.05,
    subvolume_size_sh=0.3, lambda_r0=20.0, lambda_r1=10.0, lambda_s0=20.0, lambda_s1=10.0, fix_poses=True,
    fix_intrinsics=True, fix_distortion=True,
)


def dryrun_rank(mesh: Mesh) -> List[str]:
    """Every phase of the dry run on this rank, each held to the port's
    single-device path on the same inputs (the JAX dry run's bars; the
    card's reduction order loosens the SVSH and recolor ones, as the JAX
    dry run does on an accelerator). Returns rank 0's report lines."""
    n = mesh.size
    on_cpu = mesh.device.type == "cpu"
    lines = []
    prob = small_problem()

    bprob = block_problem_inputs(prob, blocks_multiple=n)
    halo = halo_task(mesh, bprob)
    for name, r in halo.items():
        lhs, rhs = r["adjoint"]
        if r["apply_err"] != 0.0 or r["transpose_err"] > 1e-12 or abs(lhs - rhs) > 1e-9 * max(1.0, abs(lhs)):
            raise AssertionError(f"sharded {name} plan differs from the single-device plan: {r}")
    lines.append(f"dryrun({n}) halo: sharded shift plans == single-device plans, adjoint "
                 f"{halo['sdf']['adjoint'][0]:.9e} == {halo['sdf']['adjoint'][1]:.9e}")
    for schur in (False, True, "poses"):
        r = spmd_step_task(mesh, bprob, schur=schur)
        sp, one = r["spmd"], r["single"]
        if not (np.isfinite(sp["cost0"]) and sp["cost1"] <= sp["cost0"]):
            raise AssertionError(f"spmd step did not decrease the cost: {sp['cost0']} -> {sp['cost1']}")
        if abs(sp["cost0"] - one["cost0"]) > 1e-4 * max(1.0, abs(one["cost0"])):
            raise AssertionError(f"spmd cost {sp['cost0']} != single-device {one['cost0']}")
        tag = {False: "", True: "[schur]", "poses": "[schur:poses]"}[schur]
        lines.append(f"dryrun({n}) spmd{tag}: cost {sp['cost0']:.6e} -> {sp['cost1']:.6e} "
                     f"({sp['tries']} LM tries; single-device {one['cost0']:.6e} -> {one['cost1']:.6e}); "
                     f"brick {r['m']} rows, halo rows {r['hs']} over shifts {r['shifts']}, collectives "
                     f"{r['collectives']}")

    lp = level_inputs(prob)
    pipe = pipeline_task(mesh, lp)
    for mode, runs in pipe.items():
        np.testing.assert_allclose(runs["mesh"]["costs_before"], runs["single"]["costs_before"], rtol=1e-4)
        np.testing.assert_allclose(runs["mesh"]["costs_after"], runs["single"]["costs_after"], rtol=1e-3)
        lines.append(f"dryrun({n}) pipeline[{mode}]: costs {[round(c, 6) for c in runs['mesh']['costs_before']]} "
                     f"== single-device (bucket blocks {runs['mesh']['bucket_blocks']})")

    st = stages_task(mesh, lp)
    if on_cpu:
        np.testing.assert_allclose(st["coeffs"], st["single_coeffs"], rtol=2e-3, atol=2e-5)
    else:
        np.testing.assert_allclose(st["coeffs"], st["single_coeffs"], rtol=5e-2, atol=1.5e-4)
    bad = {k: f for k, f in st["fractions"].items() if f > 1.0 / n + 1e-9}
    if bad:
        raise AssertionError(f"fields not split 1/{n}: {bad}")
    lines.append(f"dryrun({n}) stages: sharded SVSH ({st['num_subvolumes']} subvolumes) matches single-device; "
                 f"recolor has {int(st['has'].sum())} observed voxels; placement fractions {st['fractions']}")

    scene = sphere_scene()
    fu = fusion_task(mesh, scene)
    for key in ("sdf", "weight"):
        np.testing.assert_array_equal(fu["mesh"][key], fu["single"][key])
    np.testing.assert_allclose(fu["mesh"]["color"], fu["single"]["color"], rtol=1e-5, atol=1e-4)
    lines.append(f"dryrun({n}) fusion: {len(fu['mesh']['sdf'])} voxels integrated on {n} ranks == single-device")

    ml = mesh_loop_task(mesh, scene, MESH_LOOP_CFG)
    got, ref = ml["mesh"], ml["single"]
    if got["coords"].shape != ref["coords"].shape:
        raise AssertionError("the mesh refinement ended on another voxel set")
    np.testing.assert_allclose(got["sdf_refined"], ref["sdf_refined"], rtol=5e-3, atol=5e-5 if on_cpu else 1e-4)
    for lv_got, lv_ref in zip(got["levels"], ref["levels"]):
        np.testing.assert_allclose(lv_got["costs_before"][0], lv_ref["costs_before"][0], rtol=1e-3)
    for records in ml["placements"]:
        for name, total, mine in records:
            if mine > total / n * 2.0 + 4096:
                raise AssertionError(f"{name}: {mine} of {total} bytes on one rank")
    lines.append(f"dryrun({n}) mesh-level-loop: {len(ml['placements'])} placement records sets through "
                 f"MeshLevelRunner, levels {[lv['level'] for lv in got['levels']]}, refined sdf == single-device")
    return lines if mesh.rank == 0 else []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world-size", type=int, default=None, help="ranks to spawn (not under torchrun)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", default="cuda", help="cuda (card rank %% count) or cpu")
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S)
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # started by torchrun
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        mesh = init_mesh(world, rank, backend=a.backend, init_method="env://", device=a.device)
        try:
            lines = dryrun_rank(mesh)
        finally:
            close_mesh(mesh)
    else:
        if a.world_size is None:
            ap.error("--world-size is required outside torchrun")
        lines = launch(dryrun_rank, a.world_size, backend=a.backend, device=a.device, timeout=a.timeout)[0]
    for line in lines:
        print(line)
    if lines:
        print(f"dryrun: all phases passed in {time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
