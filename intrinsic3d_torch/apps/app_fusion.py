"""TSDF fusion CLI (counterpart of `intrinsic3d_tpu/apps/app_fusion.py`, the
reference's AppFusion, ``apps/src/app_fusion.cpp``): fuse all frames, or the
keyframes of a `keyframes.txt`, into the sparse voxel grid on the device,
run the distance-transform correction, drop unseen voxels, and save the
`.tsdf` volume and a marching-cubes mesh.

Usage: python -m intrinsic3d_torch.apps.app_fusion -s sensor.yml -c fusion.yml
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from intrinsic3d_torch.apps.common import ensure_parent, load_sensor, make_parser, setup_logging
from intrinsic3d_torch.config import FusionConfig, Settings
from intrinsic3d_torch.device import resolve_device
from intrinsic3d_torch.grid import algorithms as alg
from intrinsic3d_torch.grid.fusion import FusionVolume, compute_scene_voxel_bounds
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid
from intrinsic3d_torch.image.processing import erode_discontinuities
from intrinsic3d_torch.io.ply import save_ply
from intrinsic3d_torch.keyframes import KeyframeSelection
from intrinsic3d_torch.mesh import extract_surface

log = logging.getLogger("intrinsic3d")

PHASES = ("erode", "allocate", "build_grid", "integrate", "finalize", "correct_sdf", "clear_invalid_voxels")


def run(sensor, cfg: FusionConfig, device="cuda", stats: Optional[dict] = None) -> VoxelGrid:
    """The fused, corrected grid (host numpy fields). All frames' depths
    and colors go to `device` as one stack each. When `stats` is a dict, it
    receives the seconds of each of `PHASES` (host clock, the device
    synchronized at every phase end), the bitmap `dims` and the voxel counts
    `allocated` and `kept`."""
    dev = resolve_device(device)
    frame_ids = list(range(sensor.num_frames))
    if cfg.keyframes:
        try:
            sel = KeyframeSelection.load(cfg.keyframes)
            frame_ids = [i for i in frame_ids if i < len(sel.is_keyframe) and sel.is_keyframe[i]]
            log.info("fusing %d keyframes", len(frame_ids))
        except FileNotFoundError:
            log.warning("could not load keyframes %s — fusing all frames", cfg.keyframes)

    clock = [time.perf_counter()]

    def phase_end(name: str) -> None:
        if stats is None:
            return
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        stats[name] = now - clock[0]
        clock[0] = now

    clip = cfg.clip_bounds if cfg.has_clip_bounds else None
    poses = np.stack([np.asarray(sensor.pose(i), np.float64) for i in frame_ids])
    vlo, vhi = compute_scene_voxel_bounds(
        sensor.depth_cam, poses, sensor.depth_min, sensor.depth_max, cfg.voxel_size, clip
    )
    vol = FusionVolume(
        sensor.depth_cam, sensor.color_cam, cfg.voxel_size, vlo, vhi,
        sensor.depth_min, sensor.depth_max, clip_bounds=clip, device=dev,
    )
    depths = torch.as_tensor(np.stack([np.asarray(sensor.depth(i), np.float32) for i in frame_ids]), device=dev)
    if cfg.discont_window_size > 0:
        depths = erode_discontinuities(depths, cfg.discont_window_size)
    phase_end("erode")
    log.info("allocation pass over %d frames ...", len(frame_ids))
    vol.allocate_batch(depths, poses)
    phase_end("allocate")
    grid = vol.build_grid()
    phase_end("build_grid")
    log.info("allocated %d voxels (dims %s)", grid.num_voxels, vol.dims)
    if stats is not None:
        stats.update(dims=vol.dims, allocated=grid.num_voxels)

    log.info("integration pass ...")
    colors = torch.as_tensor(np.stack([np.asarray(sensor.color(i), np.float32) for i in frame_ids]), device=dev)
    vol.integrate_batch(depths, colors, poses)
    phase_end("integrate")
    grid = vol.finalize()
    phase_end("finalize")

    log.info("correct SDF ...")
    grid = alg.correct_sdf(grid, device=dev)
    phase_end("correct_sdf")
    grid = alg.clear_invalid_voxels(grid)
    phase_end("clear_invalid_voxels")
    log.info("%d voxels after cleanup", grid.num_voxels)
    if stats is not None:
        stats["kept"] = grid.num_voxels
    return grid


def main(argv=None, device="cuda"):
    args = make_parser("TSDF volumetric fusion").parse_args(argv)
    setup_logging(args.verbose)
    sensor = load_sensor(args.sensor)
    cfg = FusionConfig.from_settings(Settings.load(args.config))
    grid = run(sensor, cfg, device=device)

    if cfg.output_sdf:
        ensure_parent(cfg.output_sdf)
        grid.save(cfg.output_sdf)
        log.info("saved %s", cfg.output_sdf)
    if cfg.output_mesh:
        ensure_parent(cfg.output_mesh)
        verts, faces, cols = extract_surface(grid)
        save_ply(cfg.output_mesh, verts, faces, cols)
        log.info("saved %s (%d verts, %d faces)", cfg.output_mesh, len(verts), len(faces))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
