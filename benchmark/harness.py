"""Cells, capture and jobs of the benchmark.

A cell (an entry of `workloads` in BENCHMARK.json) names a configuration,
`configs/<config>.json`, and a traffic mix, `traffic/<traffic>.json`; each
metric is a reader `metrics/<name>.py`. A traffic mix whose job needs code
adds `traffic/<traffic>.py`, which may define any of the job kind's hooks
(`benchmark/jobs.py`: `run_job`, `warm_up`, `window`, `readings`); the hooks
it leaves out are the default's. All are found by name, so a cell, a job
kind or a metric is added by adding files.

The helpers below are what every job kind shares: the program's load, the
capture handed to it as its in-memory sensor, the start and end of a job,
the keyframe and fusion stages, and the `Recorder`, which keeps, by
reference, what the correctness check needs from each refinement level: the
level's starting state at the call of the level solve, the block parameters
its last outer step started from, and its closing state at the level's
callback.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
START = time.perf_counter()  # the run's own start, set by `benchmark.run`
HOOKS = ("run_job", "warm_up", "window", "readings")


def log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - START:7.1f}s] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    kind: SimpleNamespace  # the job kind's hooks, each bound to the kind
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list
    settings: tuple = None  # the port's (keyframes, fusion, refinement) configs


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(traffic: str, root: Path = ROOT) -> SimpleNamespace:
    """The job kind of the traffic mix `traffic`: the hooks of
    `traffic/<traffic>.py` where it has one, the default's (`benchmark/jobs.py`)
    for the rest. Each hook takes the kind first, so a default hook calls the
    mix's own (the default warm-up runs the mix's `run_job`)."""
    from benchmark import jobs

    path = root / "benchmark" / "traffic" / f"{traffic}.py"
    mod = _module(path, f"benchmark_traffic_{traffic.replace('.', '_').replace('-', '_')}") if path.exists() else None
    kind = SimpleNamespace(name=traffic)
    for hook in HOOKS:
        setattr(kind, hook, functools.partial(getattr(mod, hook, None) or getattr(jobs, hook), kind))
    return kind


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its configuration,
    traffic mix, job kind and metrics."""
    bench = load_json(root / "BENCHMARK.json")
    here = root / "benchmark"
    for w in bench["workloads"]:
        if w["name"] == name:
            return Cell(
                name=name, chips=int(w["chips"]),
                config=load_json(here / "configs" / f"{w['config']}.json"),
                traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
                kind=load_kind(w["traffic"], root),
                end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)],
            )
    raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")


def load_metric(name: str, root: Path = ROOT):
    """The reader module `metrics/<name>.py`: its `read(ctx)` returns the
    metric's value or None when it finds nothing to read."""
    return _module(root / "benchmark" / "metrics" / f"{name}.py", f"benchmark_metric_{name.replace('.', '_')}")


def settings(cfg: dict):
    """The port's stage configs from a configuration's upstream groups."""
    from intrinsic3d_torch.config import FusionConfig, KeyframesConfig, RefinementConfig, Settings

    def s(*groups):
        vals = {}
        for g in groups:
            vals.update({k: str(v) for k, v in cfg[g].items()})
        return Settings(vals)

    kf = KeyframesConfig.from_settings(s("keyframes"))
    kf = dataclasses.replace(kf, filename="")
    fu = FusionConfig.from_settings(s("fusion"))
    fu = dataclasses.replace(fu, keyframes="", output_mesh="", output_sdf="")
    rf = RefinementConfig.from_settings(s("intrinsic3d", "solver"))
    rf = dataclasses.replace(rf, keyframes="", input_sdf="", output_mesh_prefix="", output_poses_prefix="",
                             output_intrinsics_prefix="")
    return kf, fu, rf


def load_program(dev) -> None:
    """Claim the device and load the port's kernels (on the card) and its
    native host library; the first run in a checkout builds both into its
    `build/`."""
    from intrinsic3d_torch import native
    from intrinsic3d_torch.ops import build

    torch.zeros(1, device=dev).add_(1)
    if dev.type == "cuda":
        build.build_all()
    native.get_lib()


def prepare(cell: Cell, seed: int, dev) -> SimpleNamespace:
    """The cell's capture from `seed`, rendered on `dev` and handed to the
    port as its in-memory sensor on the host (the device copies freed):
    `sensor`, the host `frames` the reference reads, and `init`, the
    capture's initial poses and camera that every job starts from."""
    from benchmark import scene

    cell.settings = settings(cell.config)
    capture = scene.render_orbit(cell.config["scene"], seed, dev)
    sensor, frames = make_sensor(capture, cell.config)
    del capture
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return SimpleNamespace(sensor=sensor, frames=frames, init=initial_state(sensor))


def make_sensor(capture, cfg: dict):
    """The capture as the port's in-memory sensor (host frames), and the
    same host frames for the reference: (sensor, frames)."""
    from intrinsic3d_torch.camera import Camera
    from intrinsic3d_torch.io.memory_sensor import MemorySensor

    cam = Camera.create(capture.fx, capture.fy, capture.cx, capture.cy, capture.width, capture.height)
    colors = list(capture.colors.cpu().numpy())
    depths = list(capture.depths.cpu().numpy())
    poses = list(capture.poses.cpu().numpy())
    sensor = MemorySensor(cam, cam, colors, depths, poses, depth_min=float(cfg["sensor"]["min_depth"]),
                          depth_max=float(cfg["sensor"]["max_depth"]))
    frames = dict(colors=colors, depths=depths, poses=poses,
                  cam=dict(fx=capture.fx, fy=capture.fy, cx=capture.cx, cy=capture.cy, width=capture.width,
                           height=capture.height))
    return sensor, frames


def initial_state(sensor):
    return [np.array(sensor.pose(i)) for i in range(sensor.num_frames)], sensor.color_cam


class Recorder:
    """Keeps, for each level of the running job, its starting state (at the
    call of the level solve), the block layout and block parameters its last
    outer step started from, and its closing state (at the level's
    callback). The port's level loop reassigns the grid's fields and its
    parameters and never writes into them, so references suffice: nothing
    is copied while a job runs."""

    def __init__(self):
        self.levels: Optional[list] = None
        self._orig = None
        self._orig_step = None
        self._last_step = None  # (layout, block params) of the level's latest outer step

    def install(self):
        import intrinsic3d_torch.refine.intrinsic3d as engine_mod
        from intrinsic3d_torch.refine.optimizer import LevelSetup

        self._orig = engine_mod.optimize_level
        self._orig_step = LevelSetup.outer_step
        rec = self

        def outer_step(level, params, *args, **kw):
            rec._last_step = (level.layout, params)
            return rec._orig_step(level, params, *args, **kw)

        def optimize_level(grid, topo, params, cfg, base_cam, depths_level, images_level, voxel_sh, thres_shell,
                           rgbd_level, **kw):
            start = grid_fields(grid)
            start.update(poses=params.poses, intr=params.intr, dist=params.dist)
            rec._last_step = None
            out = rec._orig(grid, topo, params, cfg, base_cam, depths_level, images_level, voxel_sh, thres_shell,
                            rgbd_level, **kw)
            if rec.levels is not None:
                last = None
                if rec._last_step is not None:
                    layout, p = rec._last_step
                    last = dict(block=int(layout.block), block_coords=layout.block_coords, params=p)
                rec.levels.append(dict(start=start, thres=float(thres_shell), rgbd=int(rgbd_level), stats=out[2],
                                       last_step=last))
            rec._last_step = None
            return out

        engine_mod.optimize_level = optimize_level
        LevelSetup.outer_step = outer_step

    def uninstall(self):
        import intrinsic3d_torch.refine.intrinsic3d as engine_mod
        from intrinsic3d_torch.refine.optimizer import LevelSetup

        if self._orig is not None:
            engine_mod.optimize_level = self._orig
            LevelSetup.outer_step = self._orig_step
            self._orig = self._orig_step = None

    def on_level(self, info):
        if self.levels is None or not self.levels:
            return
        lv = self.levels[-1]
        lv["grid_level"] = int(info.grid_level)
        lv["lighting"] = info.lighting  # the level's SVSH estimate (subvolumes, coefficients)
        lv["end"] = grid_fields(info.grid)
        lv["end"].update(poses=info.params.poses)


def grid_fields(grid) -> dict:
    return dict(coords=grid.coords, voxel=float(grid.voxel_size), sdf=grid.sdf, weight=grid.weight,
                color=grid.color, albedo=grid.albedo, sdf_refined=grid.sdf_refined)


@dataclasses.dataclass
class Job:
    """What one job kept for the check and the metrics. A stage the job did
    not run stays None (`levels` empty), and the check skips it."""

    seconds: float = 0.0
    kf_scores: list = None
    kf_ids: list = None
    fused: dict = None
    levels: list = None
    refined: object = None
    peak_bytes: int = 0
    export_dir: str = ""
    stats: Optional[dict] = None  # the engine's phases (traced runs)
    exports: Optional[dict] = None  # the export callback's seconds
    kf_fusion_s: Optional[float] = None  # traced runs
    t0: float = 0.0


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def spans(traced: bool):
    """`record_function` marks for the profiler in traced runs, no-ops
    otherwise."""
    return torch.profiler.record_function if traced else (lambda name: contextlib.nullcontext())


def begin_job(cap, rec: Recorder, traced: bool) -> Job:
    """A new job on the capture `cap`: the sensor back at the capture's
    initial poses and camera, the recorder's level list emptied."""
    poses0, cam0 = cap.init
    for i, p in enumerate(poses0):
        cap.sensor.set_pose(i, p)
    cap.sensor.color_cam = cam0
    rec.levels = []
    return Job(stats={} if traced else None, exports={}, levels=[], t0=time.perf_counter())


def keyframes_and_fusion(cell: Cell, sensor, dev, job: Job, traced: bool):
    """The keyframes and fusion apps on `sensor` (fusing every frame), kept
    in `job`; returns (keyframe selection, fused grid)."""
    from intrinsic3d_torch.apps import app_fusion, app_keyframes

    kf_cfg, fu_cfg, _ = cell.settings
    span = spans(traced)
    with span("keyframes"):
        sel = app_keyframes.run(sensor, kf_cfg, device=dev)
    with span("fusion"):
        fused = app_fusion.run(sensor, fu_cfg, device=dev)
    if traced:
        sync(dev)
        job.kf_fusion_s = time.perf_counter() - job.t0
    job.kf_scores, job.kf_ids = list(sel.frame_scores), sel.keyframe_ids()
    job.fused = grid_fields(fused)
    return sel, fused


def end_job(job: Job, rec: Recorder, dev) -> Job:
    """Close `job` once the device has finished its work: its seconds, the
    levels the recorder kept, and its peak device memory (the largest of the
    level solves' own peaks and the allocator's peak at the end)."""
    sync(dev)
    job.seconds = time.perf_counter() - job.t0
    job.levels, rec.levels = rec.levels or [], None
    peaks = [lv["stats"].peak_bytes for lv in job.levels]
    if dev.type == "cuda":
        peaks.append(int(torch.cuda.max_memory_allocated(dev)))
    job.peak_bytes = max(peaks + [0])
    return job
