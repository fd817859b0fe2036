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
(`refine/mesh_pipeline.py`). The JAX package's background preparation
threads are not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import time
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
from intrinsic3d_torch.refine.optimizer import OptimizeStats, optimize_level
from intrinsic3d_torch.refine.residuals import Params
from intrinsic3d_torch.timer import record_phase

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
    and `refine` time each phase once under the JAX package's phase names
    (plus `topology[g*]`, the level's host stencil tables; the JAX program's
    `first_dispatch` has no counterpart) and record it with
    `timer.record_phase`, as the JAX driver does (`optimize_level` records
    the levels' `level_setup` and `solve`). When `stats` is a dict they also
    put each phase there under the same name, and then synchronize the
    device at every phase end so the seconds are the device's; without it
    the queue is left alone."""

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
        this rank's bytes) records."""
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

        # image formation model (``intrinsic3d.cpp:151-203``)
        cam = sensor.color_cam
        self.intr0 = np.asarray([float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy)], np.float32)
        self.dist0 = np.zeros(5, np.float32)

        t0 = time.perf_counter()
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
        self._phase_end(stats, "pyramids", t0)
        log.info("   frame pyramids of %d keyframes built", len(self.keyframe_ids))

    def add_callback(self, cb: Callable[[RefinementInfo], None]):
        self.callbacks.append(cb)

    def _phase_end(self, stats: Optional[dict], name: str, t0: float) -> None:
        """The phase's seconds into both sinks: `timer.record_phase` and,
        when given, the `stats` dict (the device synchronized first)."""
        if stats is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        record_phase(name, seconds)
        if stats is not None:
            stats[name] = seconds

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
                           coarsest: int, stats: Optional[dict]):
        """The pyramid levels of one grid level on one device: lighting,
        `optimize_level`, recolor and write-back, callbacks. Returns
        (params, mu)."""
        cfg = self.cfg
        for rgbd_lvl in range(cfg.num_rgbd_levels - 1, -1, -1):
            if rgbd_lvl > 0 and grid_lvl < coarsest:
                continue
            log.info("level %d (pyramid %d)", grid_lvl, rgbd_lvl)
            # lighting estimation (``intrinsic3d.cpp:250-270``)
            t0 = time.perf_counter()
            self._write_back(grid, params)
            svsh, voxel_sh = estimate_svsh(
                grid, cfg.subvolume_size_sh, cfg.subvolume_sh_lambda_reg, thres_shell, weighted=True,
                with_voxel_sh=True, nbr4=nbr4, device=self.device,
            )
            if svsh is None:
                log.warning("lighting estimation failed on level %d", grid_lvl)
                break
            self.lighting = svsh
            self._phase_end(stats, f"svsh[g{grid_lvl}p{rgbd_lvl}]", t0)

            params, mu, ostats = optimize_level(
                grid, None, params, cfg, self.sensor.color_cam, self.depths_lvl[rgbd_lvl],
                self.intens_lvl[rgbd_lvl], voxel_sh, thres_shell, rgbd_lvl, mu0=mu, cg_iters=self.cg_iters,
                device=self.device, **self.solver_kw,
            )
            if stats is not None:
                tag = f"p{rgbd_lvl}v{grid.num_voxels}"
                stats[f"level_setup[{tag}]"] = ostats.setup_seconds
                stats[f"solve[{tag}]"] = sum(ostats.iter_seconds)

            # finish rgbd level (``intrinsic3d.cpp:353-378``)
            t0 = time.perf_counter()
            self._write_back(grid, params)
            self.recompute_colors(grid, params, nbr4=nbr4)
            self._update_sensor(params)
            self._phase_end(stats, f"recolor[g{grid_lvl}p{rgbd_lvl}]", t0)

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

        return params, mu

    def refine(self, fused: VoxelGrid, stats: Optional[dict] = None) -> VoxelGrid:
        """Run the full double coarse-to-fine refinement
        (``intrinsic3d.cpp:206-295``). Returns the refined (finest) grid."""
        cfg = self.cfg
        grid = fused.to_sbr() if not fused.is_sbr else fused
        params = self._params(
            grid, self._tensor(self.poses0), self._tensor(self.intr0), self._tensor(self.dist0)
        )
        t0 = time.perf_counter()
        if self.mesh is not None:
            self._initial_recolor_mesh(grid, params)
        else:
            self.recompute_colors(grid, params)
        self._phase_end(stats, "initial_recolor", t0)

        mu = 1e-4
        coarsest = cfg.num_grid_levels - 1
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
                t0 = time.perf_counter()
                grid = alg.clear_voxels_outside_thin_shell(grid, thres_shell, device=self.device)
                self._phase_end(stats, f"sparsify[g{grid_lvl}]", t0)
                log.info("   sparsified to %d voxels", grid.num_voxels)
                params = self._params(grid, params.poses, params.intr, params.dist)
            # the level's stencil tables, shared by SVSH, recolor and the solver
            t0 = time.perf_counter()
            topo = level_topology(grid)
            nbr4 = topo.nbr4_idx
            self._phase_end(stats, f"topology[g{grid_lvl}]", t0)

            if self.mesh is not None:
                # every device stage of the level loop sharded over the mesh
                from intrinsic3d_torch.refine.mesh_pipeline import MeshLevelRunner

                runner = MeshLevelRunner(self, grid, topo, thres_shell, grid_lvl, coarsest)
                params, mu = runner.run(params, mu, self.cg_iters, stats=stats)
                self.mesh_placements.append(runner.placement)
            else:
                params, mu = self._refine_grid_level(grid, params, mu, nbr4, thres_shell, grid_lvl, coarsest, stats)

            # finish grid level: ×2 upsample (``intrinsic3d.cpp:320-333``)
            if grid_lvl > 0:
                t0 = time.perf_counter()
                self._write_back(grid, params)
                grid = alg.upsample(grid)
                self._phase_end(stats, f"upsample[g{grid_lvl}]", t0)
                params = self._params(grid, params.poses, params.intr, params.dist)

        self._write_back(grid, params)
        return grid
