"""Multi-device level loop: every device stage of one grid level on the mesh.

Counterpart of `intrinsic3d_tpu/refine/mesh_pipeline.py`.
`Intrinsic3D(mesh=...)` routes each grid level through `MeshLevelRunner`,
which keeps the level's colors and halo plans on the rank across the whole
(pyramid-level) loop:

    SVSH estimate + per-voxel SH interp   (parallel/spmd_stages.py, sharded)
      → joint GN optimization             (refine/optimizer.py::optimize_level(mesh=),
                                           parallel/spmd.py::SpmdLevel, sharded)
      → recolor sweep                     (spmd_stages, sharded; colors loop
                                           back into the next SVSH on the rank)

The outer loop is `optimize_level(mesh=)`'s, the one the single-level
multi-device callers run: it takes the level's `SpmdContext` and the rank's
per-voxel SH from the sharded SVSH and returns the table params on every
rank, which the runner places back as bricks for the recolor sweep and the
next SVSH. Colors are gathered to every rank only at pyramid-level ends
(the host-side color table); pose and intrinsics updates read only the
replicated globals. Reference orchestration: ``intrinsic3d.cpp:230-295``.
With the engine's `prefetch` (the JAX runner's `I3D_PREFETCH`), each pyramid
level's host half (the rank's statics with zero SH, the plan at the mesh's
budget, the stencil tables) is built by a `refine.optimizer.LevelPrep`
thread while the sharded SVSH runs; the `SpmdLevel`, which places tensors
on the card, is built after the join on the main thread. The JAX runner's
program warm-up (`SpmdLevel.warm`) has no counterpart.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from intrinsic3d_torch.grid.blocks import BlockLayout
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid
from intrinsic3d_torch.parallel.spmd import make_spmd_context
from intrinsic3d_torch.parallel.spmd_stages import SpmdStages, place_block_params
from intrinsic3d_torch.refine.assembly import LevelTopology
from intrinsic3d_torch.refine.optimizer import optimize_level
from intrinsic3d_torch.refine.residuals import Params

log = logging.getLogger("intrinsic3d")


class MeshLevelRunner:
    """One grid level of the refinement, sharded over `engine.mesh`."""

    def __init__(
        self,
        engine,  # Intrinsic3D
        grid: VoxelGrid,
        topo: Optional[LevelTopology],  # None: built by the level preps (or `optimize_level`)
        thres_shell: float,
        grid_lvl: int,
        coarsest: int,
    ):
        self.engine = engine
        self.grid = grid
        self.topo = topo
        self.thres_shell = float(thres_shell)
        self.grid_lvl = grid_lvl
        self.coarsest = coarsest
        self.placement = []  # (name, global bytes, this rank's bytes) records
        mesh = engine.mesh
        self.mesh = mesh
        t0 = time.perf_counter()
        self.layout = BlockLayout.build(grid, blocks_multiple=max(8, mesh.size))
        self.ctx = make_spmd_context(self.layout, mesh)
        self.stages = SpmdStages.build(
            mesh, self.ctx, self.layout, grid, engine.sensor.color_cam, engine.depths_lvl[0], engine.colors0,
            engine.cfg.subvolume_size_sh, engine.cfg.num_observations, engine.cfg.occlusion_distance,
        )
        log.info(
            "   mesh level setup: layout+halo+stages %.1fs (%d blocks / %d ranks, halo rows %s)",
            time.perf_counter() - t0, self.layout.num_blocks, mesh.size, self.ctx.halo.hs,
        )

    # -- placement ----------------------------------------------------------

    def _record(self, name: str, local: torch.Tensor, dim: int) -> None:
        """Record (name, global bytes, this rank's bytes) of a per-voxel
        field held as this rank's `m` block rows along `dim` (pad rows
        excluded): with `optimize_level`'s records of the level statics,
        the evidence that every per-voxel device field of the loop but the
        replicated table params stays 1/n per rank."""
        mine = local.element_size() * local.numel()
        self.placement.append((name, mine // local.shape[dim] * self.layout.num_blocks, mine))

    # -- the level loop -------------------------------------------------------

    def run(self, params: Params, mu: float, cg_iters: int, stats=None):
        """All pyramid levels of this grid level. Returns (table params, mu).

        Mirrors the single-device `Intrinsic3D._refine_grid_level`
        (``intrinsic3d.cpp:242-295``) with every full-grid device stage
        sharded. `stats` (a dict) receives the phase seconds under the
        single-device names."""
        from intrinsic3d_torch.refine.intrinsic3d import RefinementInfo, record_level

        engine = self.engine
        cfg = engine.cfg
        grid = self.grid
        if self.stages is None:
            log.warning("lighting estimation impossible on level %d", self.grid_lvl)
            return params, mu

        bparams_s = place_block_params(self.mesh, self.layout, params)
        color_bd = self.stages.stage_colors(grid.color)
        for name, arr, dim in (
            ("params.sdf", bparams_s.sdf[:-1], 0),
            ("params.albedo", bparams_s.albedo[:-1], 0),
            ("color", color_bd, 0),
            ("stages.valid", self.stages.valid, 0),
            ("stages.vpos", self.stages.vpos, 1),
            ("stages.subvol", self.stages.subvol, 0),
        ):
            self._record(name, arr, dim)

        for rgbd_lvl in range(cfg.num_rgbd_levels - 1, -1, -1):
            if rgbd_lvl > 0 and self.grid_lvl < self.coarsest:
                continue
            log.info("level %d (pyramid %d) [mesh]", self.grid_lvl, rgbd_lvl)
            # the rank's host statics, plan and stencil tables, built while
            # the sharded lighting estimate below runs (no collective and no
            # tensor on the thread)
            prep = (engine._level_prep(grid, self.topo, params, self.thres_shell, rgbd_lvl, layout=self.layout)
                    if engine.prefetch else None)

            # lighting estimation, sharded (``intrinsic3d.cpp:250-270``)
            t0 = time.perf_counter()
            svsh, eg_sh_dev = self.stages.svsh(bparams_s, color_bd, cfg.subvolume_sh_lambda_reg, self.thres_shell)
            if svsh is None:
                log.warning("lighting estimation failed on level %d", self.grid_lvl)
                break
            engine.lighting = svsh
            engine._phase_end(stats, f"svsh[g{self.grid_lvl}p{rgbd_lvl}]", t0)

            params, mu, st = optimize_level(
                grid, self.topo, params, cfg, None, engine.depths_lvl[rgbd_lvl], engine.intens_lvl[rgbd_lvl], None,
                self.thres_shell, rgbd_lvl, mu0=mu, cg_iters=cg_iters, mesh=self.mesh, ctx=self.ctx,
                eg_sh=eg_sh_dev, prep=prep, **engine.solver_kw,
            )
            record_level(stats, st, prep is not None, f"p{rgbd_lvl}v{grid.num_voxels}")
            self.placement += [(f"{name}[pyr{rgbd_lvl}]", total, mine) for name, total, mine in st.placement]

            # recolor (sharded) + write-back (``intrinsic3d.cpp:353-378``)
            t0 = time.perf_counter()
            bparams_s = place_block_params(self.mesh, self.layout, params)
            color_bd, has_bd = self.stages.recolor(bparams_s, color_bd)
            cols, has = self.stages.colors_to_table(color_bd, has_bd)
            grid.color = np.where(has[:, None], cols, grid.color).astype(np.float32)
            engine._update_sensor(params)  # reads only the replicated globals
            engine._phase_end(stats, f"recolor[g{self.grid_lvl}p{rgbd_lvl}]", t0)

            if engine.callbacks:
                engine._write_back(grid, params)
                info = RefinementInfo(
                    grid_level=self.grid_lvl, pyramid_level=rgbd_lvl, num_grid_levels=cfg.num_grid_levels,
                    num_pyramid_levels=cfg.num_rgbd_levels, grid=grid, params=params, lighting=svsh, stats=st,
                )
                for cb in engine.callbacks:
                    cb(info)

        return params, mu
