"""Intrinsic3D orchestrator: the double coarse-to-fine refinement driver.

Counterpart of `intrinsic3d_tpu/refine/intrinsic3d.py` on one device
(reference ``nv::Intrinsic3D``, ``libintrinsic3d/src/refinement/intrinsic3d.cpp``):
convert the fused grid to the refinement voxel type, build per-keyframe
RGB-D pyramids on the device (depth resized to the color camera), then loop
grid levels (coarse → fine; thin-shell sparsification; ×2 upsample between
levels) × RGB-D pyramid levels (all of them only on the coarsest grid),
each estimating spatially-varying SH lighting and running the joint GN
optimization; voxel colors are recomputed and the refined poses and
intrinsics written back after every level. With `mesh` every device stage
of the level loop runs spatially sharded over the ranks
(`refine/mesh_pipeline.py`). With `prefetch` (the default) the host
half of each level is built on background threads while the card works, as
in the JAX package: a level's layout, plan, stencil tables and statics
during its lighting estimate (`optimizer.LevelPrep`), the next pyramid
level's plan during the recolor, and the grid-level boundary's upsample and
sparsify index tables during the solve (`grid.algorithms.UpsamplePrep`);
the results are bitwise those of the serial path (`prefetch=False`).
Every phase is a `timer.span` on the main thread, so a profiler's timeline
names what the host does between the card's work; nothing here synchronizes
the device.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, List, Optional

import numpy as np
import torch

from intrinsic3d_torch.camera import Camera
from intrinsic3d_torch.color import intensity as rgb_intensity
from intrinsic3d_torch.config import RefinementConfig
from intrinsic3d_torch.device import resolve_device
from intrinsic3d_torch.grid import algorithms as alg
from intrinsic3d_torch.grid import ops as gops
from intrinsic3d_torch.grid.voxel_grid import NORMAL_OFFSETS, VoxelGrid
from intrinsic3d_torch.image.processing import resize_depth
from intrinsic3d_torch.image.pyramid import depth_down, pyr_down
from intrinsic3d_torch.lighting.svsh import estimate_svsh
from intrinsic3d_torch.mathutil import compute_varying_lambda, invert_pose, pose_matrix_to_vec, pose_vec_to_matrix
from intrinsic3d_torch.observations import collect_observations, recolor
from intrinsic3d_torch.refine.assembly import level_topology
from intrinsic3d_torch.refine.optimizer import LevelPrep, OptimizeStats, level_budget, optimize_level
from intrinsic3d_torch.refine.residuals import Params
from intrinsic3d_torch.timer import collect, record_phase, span

log = logging.getLogger("intrinsic3d")


@dataclasses.dataclass
class RefinementInfo:
    grid_level: int
    pyramid_level: int
    num_grid_levels: int
    num_pyramid_levels: int
    grid: VoxelGrid
    params: Params
    lighting: object  # SVSHResult
    stats: Optional[OptimizeStats] = None  # the level's solver record


class Intrinsic3D:
    """End-to-end joint appearance and geometry refinement on `device`.

    `cg_coeff_dtype` and `cg_eta` pass through to every level's
    `optimize_level` (the JAX driver runs their defaults). The constructor
    and `refine` run each phase in a `timer.span` under the JAX package's
    phase names (plus `topology[g*]`, the level's host stencil tables; the
    JAX program's `first_dispatch` has no counterpart), which records its
    host-clock seconds with `timer.record_phase`, as the JAX driver does
    (`optimize_level` records the levels' `level_setup` and `solve`). When
    `stats` is a dict they also put each phase there under the same name
    (`timer.collect`). The device is never synchronized at a phase's end:
    a phase's seconds are the host's, and its device side is read from a
    profiler's trace, inside the span. With `prefetch`, the background
    preps' own thread seconds are recorded too, under `prefetch[p*v*]` (the
    JAX package's name) and `upsample_prep[g*]`."""

    def __init__(
        self,
        cfg: RefinementConfig,
        sensor,
        keyframe_ids: List[int],
        cg_iters: int = 12,
        device="cuda",
        cg_coeff_dtype: str = "bfloat16",
        cg_eta: float = 0.1,
        stats: Optional[dict] = None,
        mesh=None,
        prefetch: bool = True,
    ):
        """`mesh` (a `parallel.sharding.Mesh`; every rank constructs the
        engine with the same inputs) runs on the mesh's device and shards
        every device stage of the level loop over the ranks: the joint GN
        optimization (bricked voxel blocks with halo exchange, the device
        assembly on the brick, all-reduced globals; parallel/spmd.py), the
        SVSH lighting estimate with the per-voxel SH, and the recolor sweep
        (parallel/spmd_stages.py), each grid level's loop in
        `refine/mesh_pipeline.py::MeshLevelRunner`, and the initial
        recolorization through the same sharded sweep
        (`_initial_recolor_mesh`). The host stages between grid levels
        (×2 upsample, thin-shell sparsify) run on every rank.
        `mesh_placements` then holds each grid level's (name, global bytes,
        this rank's bytes) records.

        `prefetch` (the JAX package's `I3D_PREFETCH`, on by default) builds
        each level's host half on background threads overlapped with the
        device stages (module docstring); `prefetch=False` builds it on the
        main thread where it is needed. Every thread is joined before
        `refine` returns or raises, and a thread's exception re-raises on
        the main thread."""
        self.cfg = cfg
        self.sensor = sensor
        self.keyframe_ids = list(keyframe_ids)
        self.cg_iters = cg_iters
        self.mesh = mesh
        self.mesh_placements: List[list] = []
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.solver_kw = dict(cg_coeff_dtype=cg_coeff_dtype, cg_eta=cg_eta)
        self.callbacks: List[Callable[[RefinementInfo], None]] = []
        self.lighting = None
        self.prefetch = prefetch
        self._preps: list = []  # the preps started by the running `refine`
        self._depths_host: dict = {}  # pyramid level -> its depth maps on the host

        # image formation model (``intrinsic3d.cpp:151-203``)
        cam = sensor.color_cam
        self.intr0 = np.asarray([float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy)], np.float32)
        self.dist0 = np.zeros(5, np.float32)

        with collect(stats), span("pyramids", phase=True):
            colors_np = np.stack([np.asarray(sensor.color(i), np.float32) for i in self.keyframe_ids])  # [K, H, W, 3]
            depths_np = np.stack([np.asarray(sensor.depth(i), np.float32) for i in self.keyframe_ids])
            self.poses0 = np.stack(
                [pose_matrix_to_vec(invert_pose(sensor.pose(i))) for i in self.keyframe_ids]
            ).astype(np.float32)  # [K, 6] world→cam
            dev = self.device
            colors = torch.as_tensor(colors_np, device=dev)
            depths = resize_depth(sensor.depth_cam, torch.as_tensor(depths_np, device=dev), cam)
            self.depths_lvl = [depths]
            self.intens_lvl = [rgb_intensity(colors)]
            for _ in range(1, cfg.num_rgbd_levels):
                colors = pyr_down(colors)
                self.intens_lvl.append(rgb_intensity(colors))
                self.depths_lvl.append(depth_down(self.depths_lvl[-1]))
            self.colors0 = torch.as_tensor(np.clip(colors_np * 255.0, 0.0, 255.0).astype(np.uint8), device=dev)
        log.info("   frame pyramids of %d keyframes built", len(self.keyframe_ids))

    def add_callback(self, cb: Callable[[RefinementInfo], None]):
        self.callbacks.append(cb)

    def _start(self, prep):
        """Track a started prep, so that `refine` joins it on every exit
        (the ended ones are let go, with their host products)."""
        self._preps = [p for p in self._preps if p.alive] + [prep]
        return prep

    def _host_depths(self, rgbd_lvl: int) -> np.ndarray:
        """The pyramid level's depth maps on the host (pulled once), for the
        level preps' planners."""
        if rgbd_lvl not in self._depths_host:
            self._depths_host[rgbd_lvl] = self.depths_lvl[rgbd_lvl].cpu().numpy()
        return self._depths_host[rgbd_lvl]

    def _level_prep(self, grid: VoxelGrid, topo, params: Params, thres_shell: float, rgbd_lvl: int,
                    layout=None, program_only: bool = False) -> LevelPrep:
        """Start the `LevelPrep` of a (grid, pyramid) level at this engine's
        budget (on the mesh: the mesh's, on its layout)."""
        mesh = self.mesh
        return self._start(LevelPrep(
            grid, topo, params, self.cfg, self._host_depths(rgbd_lvl), thres_shell, rgbd_lvl,
            budget=level_budget(self.device, mesh), layout=layout,
            blocks_multiple=8 if mesh is None else max(8, mesh.size), program_only=program_only,
        ))

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _params(self, grid: VoxelGrid, poses, intr, dist) -> Params:
        return Params(
            sdf=self._tensor(grid.sdf_refined), albedo=self._tensor(grid.albedo), poses=poses, intr=intr, dist=dist
        )

    # ------------------------------------------------------------------

    def recompute_colors(self, grid: VoxelGrid, params: Params, nbr4: Optional[np.ndarray] = None) -> None:
        """Full observation resweep recoloring (``intrinsic3d.cpp:381-409``):
        normals → iso-projection → observation collection → weighted recolor
        on the device; voxels without an observation keep their color."""
        if nbr4 is None:
            nbr4 = grid.neighbor_table(NORMAL_OFFSETS)
        normals, _ = gops.surface_normals(
            params.sdf, self._tensor(nbr4, torch.int64), self._tensor(grid.valid_mask(), torch.bool)
        )
        iso = gops.voxel_center_to_iso(self._tensor(grid.voxel_to_world()), normals, params.sdf)
        cam0 = self.sensor.color_cam
        intr = params.intr
        cam = Camera(fx=intr[0], fy=intr[1], cx=intr[2], cy=intr[3], width=cam0.width, height=cam0.height,
                     dist=params.dist)
        w, f = collect_observations(
            cam, params.poses, self.depths_lvl[0], iso, normals, self.cfg.occlusion_distance,
            num_best=self.cfg.num_observations,
        )
        cols, has = recolor(cam, params.poses, self.colors0, iso, w, f)
        cols, has = cols.cpu().numpy(), has.cpu().numpy()
        grid.color = np.where(has[:, None], cols, grid.color).astype(np.float32)

    def _initial_recolor_mesh(self, grid: VoxelGrid, params: Params) -> None:
        """The initial recolorization (``intrinsic3d.cpp:214-217``) sharded
        over `self.mesh` through the level loop's `SpmdStages.recolor`, so no
        device stage holds the full grid on one rank. A grid without a
        subvolume partition (an empty scene) takes the single-device sweep."""
        from intrinsic3d_torch.grid.blocks import BlockLayout
        from intrinsic3d_torch.parallel.spmd import make_spmd_context
        from intrinsic3d_torch.parallel.spmd_stages import SpmdStages, place_block_params

        layout = BlockLayout.build(grid, blocks_multiple=max(8, self.mesh.size))
        stages = SpmdStages.build(
            self.mesh, make_spmd_context(layout, self.mesh), layout, grid, self.sensor.color_cam,
            self.depths_lvl[0], self.colors0, self.cfg.subvolume_size_sh, self.cfg.num_observations,
            self.cfg.occlusion_distance,
        )
        if stages is None:
            self.recompute_colors(grid, params)
            return
        color_bd, has_bd = stages.recolor(place_block_params(self.mesh, layout, params), stages.stage_colors(grid.color))
        cols, has = stages.colors_to_table(color_bd, has_bd)
        grid.color = np.where(has[:, None], cols, grid.color).astype(np.float32)
        self.mesh_placements.append(
            [("initial_recolor.color", color_bd.element_size() * layout.num_blocks * color_bd[0].numel(),
              color_bd.element_size() * color_bd.numel())]
        )

    def _write_back(self, grid: VoxelGrid, params: Params) -> None:
        grid.sdf_refined = params.sdf.cpu().numpy().astype(np.float32)
        grid.albedo = params.albedo.cpu().numpy().astype(np.float32)

    def _update_sensor(self, params: Params) -> None:
        """Refined poses and intrinsics back into the sensor
        (``intrinsic3d.cpp:353-378``)."""
        poses = params.poses.cpu().numpy()
        for i, fid in enumerate(self.keyframe_ids):
            self.sensor.set_pose(fid, invert_pose(pose_vec_to_matrix(poses[i])))
        intr = params.intr.cpu().numpy()
        cam = self.sensor.color_cam
        self.sensor.color_cam = Camera.create(
            intr[0], intr[1], intr[2], intr[3], cam.width, cam.height, params.dist.cpu().numpy()
        )

    # ------------------------------------------------------------------

    def _refine_grid_level(self, grid: VoxelGrid, params: Params, mu, nbr4, thres_shell: float, grid_lvl: int,
                           coarsest: int):
        """The pyramid levels of one grid level on one device: lighting,
        `optimize_level`, recolor and write-back, callbacks. With
        `prefetch`, the level preps start where the JAX level loop starts them
        (`intrinsic3d_tpu/refine/intrinsic3d.py:365-425`). Returns (params,
        mu, the boundary's `UpsamplePrep` or None)."""
        cfg = self.cfg
        prep = bprep = None
        for rgbd_lvl in range(cfg.num_rgbd_levels - 1, -1, -1):
            if rgbd_lvl > 0 and grid_lvl < coarsest:
                continue
            log.info("level %d (pyramid %d)", grid_lvl, rgbd_lvl)
            if prep is None and self.prefetch:
                # the level's layout, plan, stencil tables and statics, built
                # while the lighting estimate below runs
                prep = self._level_prep(grid, None, params, thres_shell, rgbd_lvl)
            # lighting estimation (``intrinsic3d.cpp:250-270``)
            with span(f"svsh[g{grid_lvl}p{rgbd_lvl}]", phase=True):
                self._write_back(grid, params)
                svsh, voxel_sh = estimate_svsh(
                    grid, cfg.subvolume_size_sh, cfg.subvolume_sh_lambda_reg, thres_shell, weighted=True,
                    with_voxel_sh=True, nbr4=nbr4, device=self.device,
                )
            if svsh is None:
                log.warning("lighting estimation failed on level %d", grid_lvl)
                break
            self.lighting = svsh

            if self.prefetch and grid_lvl > 0 and bprep is None:
                # the boundary's coordinates-only structure, built while the
                # solve below runs
                bprep = self._start(alg.UpsamplePrep(grid, device=self.device))
            params, mu, ostats = optimize_level(
                grid, None, params, cfg, self.sensor.color_cam, self.depths_lvl[rgbd_lvl],
                self.intens_lvl[rgbd_lvl], voxel_sh, thres_shell, rgbd_lvl, mu0=mu, cg_iters=self.cg_iters,
                device=self.device, prep=prep, **self.solver_kw,
            )
            next_r = rgbd_lvl - 1
            if self.prefetch and next_r >= 0 and (grid_lvl == coarsest or next_r == 0):
                # the next pyramid level's plan, on this level's layout, while
                # this level recolors and the next lighting estimate runs
                prep = self._level_prep(grid, None, params, thres_shell, next_r, layout=prep.layout,
                                        program_only=True)
            else:
                prep = None

            # finish rgbd level (``intrinsic3d.cpp:353-378``)
            with span(f"recolor[g{grid_lvl}p{rgbd_lvl}]", phase=True):
                self._write_back(grid, params)
                self.recompute_colors(grid, params, nbr4=nbr4)
                self._update_sensor(params)

            info = RefinementInfo(
                grid_level=grid_lvl,
                pyramid_level=rgbd_lvl,
                num_grid_levels=cfg.num_grid_levels,
                num_pyramid_levels=cfg.num_rgbd_levels,
                grid=grid,
                params=params,
                lighting=svsh,
                stats=ostats,
            )
            for cb in self.callbacks:
                cb(info)

        return params, mu, bprep

    def refine(self, fused: VoxelGrid, stats: Optional[dict] = None) -> VoxelGrid:
        """Run the full double coarse-to-fine refinement
        (``intrinsic3d.cpp:206-295``). Returns the refined (finest) grid.
        Every background prep it starts is joined before it returns or
        raises. When `stats` is a dict, it receives every phase's seconds."""
        try:
            with collect(stats):
                return self._refine(fused)
        finally:
            for prep in self._preps:
                prep.wait()
            self._preps.clear()

    def _refine(self, fused: VoxelGrid) -> VoxelGrid:
        cfg = self.cfg
        grid = fused.to_sbr() if not fused.is_sbr else fused
        params = self._params(
            grid, self._tensor(self.poses0), self._tensor(self.intr0), self._tensor(self.dist0)
        )
        with span("initial_recolor", phase=True):
            if self.mesh is not None:
                self._initial_recolor_mesh(grid, params)
            else:
                self.recompute_colors(grid, params)

        mu = 1e-4
        coarsest = cfg.num_grid_levels - 1
        bprep = None  # the boundary's UpsamplePrep
        for grid_lvl in range(coarsest, -1, -1):
            log.info("refinement on grid level %d (voxel %.4f, %d voxels)", grid_lvl, grid.voxel_size, grid.num_voxels)
            # thin-shell threshold schedule (``intrinsic3d.cpp:298-318``)
            factor = cfg.thin_shell_factor
            if cfg.thin_shell_factor_final > 0.0:
                factor = compute_varying_lambda(
                    coarsest - grid_lvl, cfg.num_grid_levels, cfg.thin_shell_factor, cfg.thin_shell_factor_final
                )
            thres_shell = factor * grid.voxel_size
            if cfg.clear_distant_voxels:
                with span(f"sparsify[g{grid_lvl}]", phase=True):
                    shell = bprep.shell_for(grid) if bprep is not None else None
                    grid = alg.clear_voxels_outside_thin_shell(grid, thres_shell, device=self.device, shell=shell)
                log.info("   sparsified to %d voxels", grid.num_voxels)
                params = self._params(grid, params.poses, params.intr, params.dist)
            bprep = None
            # the level's stencil tables: with `prefetch` the main thread
            # builds only the normal stencil (SVSH, recolor) and the level
            # preps build the rest (`level_topology`, memoized per grid)
            with span(f"topology[g{grid_lvl}]", phase=True):
                if self.prefetch:
                    topo = None
                    nbr4 = grid.neighbor_table(NORMAL_OFFSETS) if self.mesh is None else None
                else:
                    topo = level_topology(grid)
                    nbr4 = topo.nbr4_idx

            if self.mesh is not None:
                # every device stage of the level loop sharded over the mesh
                from intrinsic3d_torch.refine.mesh_pipeline import MeshLevelRunner

                runner = MeshLevelRunner(self, grid, topo, thres_shell, grid_lvl, coarsest)
                params, mu = runner.run(params, mu, self.cg_iters)
                self.mesh_placements.append(runner.placement)
            else:
                params, mu, bprep = self._refine_grid_level(grid, params, mu, nbr4, thres_shell, grid_lvl, coarsest)

            # finish grid level: ×2 upsample (``intrinsic3d.cpp:320-333``)
            if grid_lvl > 0:
                with span(f"upsample[g{grid_lvl}]", phase=True):
                    self._write_back(grid, params)
                    grid = alg.upsample(grid, prep=bprep)
                if bprep is not None:
                    # the prep's own thread seconds, overlapped with the solve
                    record_phase(f"upsample_prep[g{grid_lvl}]", bprep.seconds)
                params = self._params(grid, params.poses, params.intr, params.dist)

        self._write_back(grid, params)
        return grid
