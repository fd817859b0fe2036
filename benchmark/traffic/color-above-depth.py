"""Colour above depth: `orbit10kf.reconstruct`'s job on a capture whose
colour camera is larger than its depth camera, as a Structure Sensor on an
iPad captures it (ScanNet: 1296x968 colour over 640x480 depth). The two
cameras are a registered pair: one centre, the same poses.

The capture that `harness.prepare` renders from the seed is the depth
capture (the configuration's `scene` size). The first job on it
(`run_job`, in set-up: the warm-up's) renders the same orbit once more at
the `color` group's size, from the same start view, read off the first
pose, with the image noise seeded from the depth capture's own noisy colour
frames, so that a seed gives the same colour frames in every run; the
poses are asserted bitwise those of the depth capture. The sensor is then
handed the colour frames and the colour camera (`color_cam`, by the
scene's focal rule at the colour size), and keeps the depth frames and the
depth camera; the capture's `init` carries the colour camera, which
`harness.begin_job` hands the sensor at every job's start. So keyframe
selection reads the colour frames, fusion looks up depth through the depth
camera and colour through the colour camera, and `Intrinsic3D` reprojects
each keyframe's depth to the colour camera and refines at the colour
resolution. `run_job` also keeps, beside each level the recorder keeps,
the depth maps the level solve received (`depths`).

`readings` is `benchmark/check.py`'s check with two cameras: keyframes on
the colour frames; fusion against `reference/fusion_two_cameras.py`; every
level against reference pyramids built from the reference's own
reprojection of the keyframes' depth (`reference/reproject.py`) at the
colour camera; and `reproject_gap`, the 99th percentile over the pixels
valid in either map of |the depth maps each pyramid-0 level's solve
received − the float64 reprojection| over the reprojection, a pixel valid
in one map only counting 1 (the largest over those levels). With
`control=True` the reference computed in bfloat16, the reprojection
included, stands in the program's place.
"""

from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np
import torch

from benchmark import check, jobs, scene
from benchmark.reference import energy, fusion, fusion_two_cameras, reproject

REF, LOW = check.REF, check.LOW


def color_scene(cfg: dict) -> dict:
    """The configuration's scene at the colour camera's size."""
    return dict(cfg["scene"], width=int(cfg["color"]["width"]), height=int(cfg["color"]["height"]))


def color_cam(cfg: dict) -> dict:
    """The colour camera (fx, fy, cx, cy, width, height): the scene's focal
    rule at the colour size, float32-rounded as the capture holds it."""
    s = color_scene(cfg)
    w, h = s["width"], s["height"]
    f = scene.f32(s["focal_factor"] * max(w, h))
    return dict(fx=f, fy=f, cx=scene.f32((w - 1) / 2.0), cy=scene.f32((h - 1) / 2.0), width=w, height=h)


def start_view(cfg: dict, pose0) -> int:
    """The ring view of the orbit whose camera-to-world pose is `pose0`."""
    s = cfg["scene"]
    n = int(s["frames"])
    eye = np.asarray(pose0, np.float64)[:3, 3] - np.asarray(s["center"], np.float64)
    ang = math.atan2(eye[0], -eye[2])
    return int(round(ang * n / (2.0 * math.pi) - float(s.get("phase", 0.0)))) % n


def color_capture(cell, cap, dev) -> None:
    """Hand `cap`'s sensor the colour frames and camera (module docstring);
    once a capture."""
    from intrinsic3d_torch.camera import Camera
    from intrinsic3d_torch.io.memory_sensor import MemorySensor

    if getattr(cap, "color_cam", None) is not None:
        return
    cfg = cell.config
    poses = np.stack(cap.frames["poses"])
    noise_seed = zlib.crc32(np.ascontiguousarray(cap.frames["colors"][0]).tobytes())
    col = scene.render_orbit(color_scene(cfg), noise_seed, dev, start=start_view(cfg, poses[0]))
    if not np.array_equal(col.poses.cpu().numpy(), poses):
        raise AssertionError("the colour capture's poses are not the depth capture's")
    cam = color_cam(cfg)
    if (col.fx, col.fy, col.cx, col.cy) != (cam["fx"], cam["fy"], cam["cx"], cam["cy"]):
        raise AssertionError(f"the colour capture's camera {(col.fx, col.fy, col.cx, col.cy)} is not {cam}")
    colors = list(col.colors.cpu().numpy())
    del col
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ccam = Camera.create(cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["width"], cam["height"])
    s = cap.sensor
    cap.sensor = MemorySensor(ccam, s.depth_cam, colors, cap.frames["depths"], cap.frames["poses"],
                              depth_min=s.depth_min, depth_max=s.depth_max)
    cap.frames["colors"] = colors
    cap.init = (cap.init[0], ccam)
    cap.color_cam = cam


def run_job(kind, cell, cap, dev, rec, traced: bool, scratch: str, index: int):
    """The default job on the colour capture, keeping each level's depth
    maps (module docstring)."""
    import intrinsic3d_torch.refine.intrinsic3d as engine_mod

    color_capture(cell, cap, dev)
    level = engine_mod.optimize_level

    def optimize_level(*args, **kw):
        out = level(*args, **kw)
        if rec.levels:
            rec.levels[-1]["depths"] = args[5]  # `depths_level`, by reference
        return out

    engine_mod.optimize_level = optimize_level
    try:
        return jobs.run_job(kind, cell, cap, dev, rec, traced, scratch, index)
    finally:
        engine_mod.optimize_level = level


class ColorFrames(check.Frames):
    """`check.Frames` through the colour camera: `cam` is the colour camera
    and each keyframe pyramid is built from the keyframes' depth reprojected
    to it by the reference, in the pyramid's own dtype; `raw_depths` and
    `depth_cam` are the depth capture's."""

    def __init__(self, frames: check.Frames, cam: dict):
        self.__dict__.update(frames.__dict__)
        self.raw_depths, self.depth_cam, self.cam = frames.depths, frames.cam, cam
        self._pyr = {}

    def reprojected(self, ids, dtype):
        i = torch.as_tensor(list(ids), device=self.dev)
        return reproject.resize_depth(self.raw_depths[i], self.depth_cam, self.cam, dtype)

    def keyframes(self, ids, levels: int, dtype):
        key = (tuple(ids), dtype)
        if key not in self._pyr:
            i = torch.as_tensor(list(ids), device=self.dev)
            self._pyr[key] = energy.pyramid(self.colors[i], self.reprojected(ids, dtype), levels, dtype)
        return self._pyr[key]


def color_frames(frames: check.Frames, cfg: dict) -> ColorFrames:
    """The run's `ColorFrames`, made once beside its `check.Frames`."""
    if getattr(frames, "color_view", None) is None:
        frames.color_view = ColorFrames(frames, color_cam(cfg))
    return frames.color_view


def fusion_readings(job, frames: check.Frames, cfg: dict, control: bool) -> dict:
    fr = (frames.depths, frames.colors, frames.poses, frames.cam, color_cam(cfg), cfg["fusion"],
          float(cfg["sensor"]["min_depth"]), float(cfg["sensor"]["max_depth"]))
    ref = fusion_two_cameras.fuse(*fr, dtype=REF)
    if control:
        c, s, w, col = fusion_two_cameras.fuse(*fr, dtype=LOW)
        cand = dict(coords=c, sdf=s, weight=w, color=col)
    else:
        cand = job.fused
    return fusion.compare_fused(cand, ref, float(cfg["fusion"]["voxel_size"]))


def reproject_readings(job, fr: ColorFrames, control: bool) -> dict:
    levels = [lv for lv in job.levels if int(lv["rgbd"]) == 0 and "depths" in lv]
    if not levels or job.kf_ids is None:
        return {}
    ref = fr.reprojected(job.kf_ids, REF)
    if control:
        return dict(reproject_gap=reproject.reproject_gap(fr.reprojected(job.kf_ids, LOW), ref))
    return dict(reproject_gap=max(reproject.reproject_gap(lv["depths"], ref) for lv in levels))


def readings(kind, job, frames, cell, control: bool = False, detail=None) -> dict:
    """Every stage the job ran, held against the plain reference with two
    cameras (module docstring)."""
    cfg = cell.config
    fr = color_frames(frames, cfg)
    # keyframes on the colour frames, and the refinement's gain
    out = check.job_readings(dataclasses.replace(job, fused=None, levels=[]), fr, cfg, None, control=control)
    if job.fused is not None:
        out.update(fusion_readings(job, frames, cfg, control))
    if job.levels:
        out.update(check.level_readings(job, fr, cfg, control, detail))
        out.update(reproject_readings(job, fr, control))
    return out
