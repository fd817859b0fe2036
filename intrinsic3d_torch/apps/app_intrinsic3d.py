"""Joint refinement CLI (counterpart of `intrinsic3d_tpu/apps/app_intrinsic3d.py`,
the reference's AppIntrinsic3D, ``apps/src/app_intrinsic3d.cpp``): load the
fused `.tsdf` volume and the keyframes, run the double coarse-to-fine joint
optimization on the device; after every (grid, pyramid) level the callback
exports meshes in every enabled color mode, the refined poses (TUM) and the
color intrinsics.

Usage: python -m intrinsic3d_torch.apps.app_intrinsic3d -s sensor.yml -c intrinsic3d.yml
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from intrinsic3d_torch import visualization as vis
from intrinsic3d_torch.apps.common import ensure_parent, load_sensor, make_parser, setup_logging
from intrinsic3d_torch.config import RefinementConfig, Settings
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid
from intrinsic3d_torch.io.trajectory import save_poses
from intrinsic3d_torch.keyframes import KeyframeSelection
from intrinsic3d_torch.refine.intrinsic3d import Intrinsic3D, RefinementInfo

log = logging.getLogger("intrinsic3d")


def make_callback(cfg: RefinementConfig, sensor, engine: Intrinsic3D, stats: Optional[dict] = None):
    """Per-level artifact export (``app_intrinsic3d.cpp:159-209``). When
    `stats` is a dict, its `exports` entry sums the seconds spent here."""

    def on_refined(info: RefinementInfo):
        t0 = time.perf_counter()
        postfix = f"_g{info.grid_level}_p{info.pyramid_level}"
        if cfg.output_mesh_prefix:
            ensure_parent(cfg.output_mesh_prefix)
            grid_vis = info.grid.clone()
            grid_vis.sdf = grid_vis.sdf_refined.copy()
            for mode in vis.output_modes(cfg, add_voxel_colors=True):
                vis.export_mesh(
                    grid_vis,
                    cfg.output_mesh_prefix,
                    mode,
                    lighting=info.lighting,
                    largest_comp_only=cfg.output_mesh_largest_comp_only,
                    suffix=postfix,
                    device=engine.device,
                )
        if cfg.output_poses_prefix:
            ensure_parent(cfg.output_poses_prefix)
            poses = [sensor.pose(i) for i in range(sensor.num_frames)]
            ts = [float(i) for i in range(sensor.num_frames)]
            save_poses(cfg.output_poses_prefix + postfix + ".txt", poses, ts)
        if cfg.output_intrinsics_prefix:
            ensure_parent(cfg.output_intrinsics_prefix)
            sensor.color_cam.save(cfg.output_intrinsics_prefix + postfix + ".txt")
        if stats is not None:
            stats["exports"] = stats.get("exports", 0.0) + time.perf_counter() - t0

    return on_refined


def main(argv=None, device="cuda", stats: Optional[dict] = None):
    """When `stats` is a dict, it receives the engine's phase seconds
    (`Intrinsic3D`'s) and the callback's `exports` seconds."""
    args = make_parser("Joint appearance and geometry refinement").parse_args(argv)
    setup_logging(args.verbose)
    sensor = load_sensor(args.sensor)
    cfg = RefinementConfig.from_settings(Settings.load(args.config))

    keyframes = KeyframeSelection.load(cfg.keyframes)
    kf_ids = keyframes.keyframe_ids()
    log.info("%d keyframes", len(kf_ids))

    grid = VoxelGrid.load(cfg.input_sdf, sensor.depth_min, sensor.depth_max)
    log.info("loaded %s: %d voxels at %.4f m", cfg.input_sdf, grid.num_voxels, grid.voxel_size)

    engine = Intrinsic3D(cfg, sensor, kf_ids, device=device, stats=stats)
    engine.add_callback(make_callback(cfg, sensor, engine, stats))
    refined = engine.refine(grid, stats=stats)
    log.info("refinement done: %d voxels at %.4f m", refined.num_voxels, refined.voxel_size)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
