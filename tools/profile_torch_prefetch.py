#!/usr/bin/env python3
"""What the level pipeline's background preps cost on the host, stage by
stage, and how long each stage keeps the main thread from the GIL.

    python3 tools/profile_torch_prefetch.py [--device cuda|cpu] [--frames 30] [--size 640x480] [--voxel 0.004]

Runs keyframes + fusion of bench_pipeline.py's orbit on the device, then
`Intrinsic3D.refine` (`PIPELINE_REFINEMENT`, the level pipeline off) while
recording the grid, poses and depth maps each grid level's first pyramid
level starts from. Then, with the device idle, for each recorded level it
runs every stage of a `LevelPrep` (the block layout, the plan, the stencil
tables, the statics with zero SH) and, for the grid levels that are
upsampled, of an `UpsamplePrep` (the corner lookup, the child skeleton and
reorder, the child's sparsify inputs) on a background thread, one stage at a
time, while the main thread launches tiny device operations back to back, as
the eager solve does. Each operation releases the GIL inside ATen and takes
it back after, so while a stage holds the GIL the main thread waits: the
convoy. On the card it also times the statics' build there, from the
layout, on the main thread (`build_level_static`), which replaces the
stencil tables and the host statics of a single-device level's prep. Per
stage it prints the stage's seconds, the main thread's
operations in that time, their median and largest duration, and the
seconds they took beyond the idle median (the convoy seconds; its share of
the stage's seconds is what the solve would lose while that stage
overlaps it). Last, each prep whole, as the refinement runs it
(`level_prep`, `upsample_prep`). Writes chiprun_out/profile_prefetch.json.
On the card a level's prep builds the layout and the plan only.

`--device cpu` runs it on the host at a small size (`--frames 8 --size
160x120 --voxel 0.02`), for rehearsal: its seconds are the CPU's.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
IDLE_OPS = 20000


def tick_while(alive, op) -> list:
    """Durations (s) of `op()` called back to back while `alive()`."""
    out = []
    while alive():
        t0 = time.perf_counter()
        op()
        out.append(time.perf_counter() - t0)
    return out


def stage_convoy(fn, op, idle_median: float) -> dict:
    """`fn()` on a background thread while the main thread calls `op()`:
    the thread's seconds and the main thread's operations meanwhile."""
    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            box["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            box["exc"] = exc
        box["seconds"] = time.perf_counter() - t0

    th = threading.Thread(target=run, name="profile-stage")
    th.start()
    ops = tick_while(th.is_alive, op)
    th.join()
    if "exc" in box:
        raise box["exc"]
    convoy = sum(max(0.0, d - idle_median) for d in ops)
    return dict(seconds=box["seconds"], ops=len(ops), op_median_us=1e6 * statistics.median(ops) if ops else 0.0,
                op_max_ms=1e3 * max(ops) if ops else 0.0, convoy_s=convoy,
                convoy_share=convoy / box["seconds"] if box["seconds"] > 0 else 0.0, value=box.get("value"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--size", default=None, help="WxH of the orbit frames")
    ap.add_argument("--voxel", type=float, default=None, help="fusion voxel size (m)")
    args = ap.parse_args()
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from intrinsic3d_torch.apps import app_fusion, app_keyframes
    from intrinsic3d_torch.device import resolve_device
    from intrinsic3d_torch.grid import algorithms as alg
    from intrinsic3d_torch.grid.blocks import BlockLayout
    from intrinsic3d_torch.refine import intrinsic3d
    from intrinsic3d_torch.refine import optimizer as opt
    from intrinsic3d_torch.refine.assembly import LevelTopology
    from intrinsic3d_torch.refine.device_assembly import build_level_static, level_static_host
    from intrinsic3d_torch.synthetic import (
        PIPELINE_CG_ITERS,
        PIPELINE_DATASET,
        PIPELINE_REFINEMENT,
        PIPELINE_SETTINGS,
        build_orbit_dataset,
        pipeline_configs,
    )

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    dataset, settings = dict(PIPELINE_DATASET), dict(PIPELINE_SETTINGS)
    if args.frames:
        dataset["num_frames"] = args.frames
    if args.size:
        dataset["width"], dataset["height"] = (int(v) for v in args.size.split("x"))
    if args.voxel:
        settings["voxel_size"] = args.voxel
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    else:
        smi = "cpu (rehearsal: host seconds)"
    print(smi, flush=True)

    sensor = build_orbit_dataset(**dataset)
    kcfg, fcfg = pipeline_configs(dataset["center"], dataset["radius"], **settings)
    kf_ids = app_keyframes.run(sensor, kcfg, device=dev).keyframe_ids()
    fused = app_fusion.run(sensor, fcfg, device=dev)

    levels = []
    real = intrinsic3d.optimize_level

    def record(grid, topo, params, cfg, cam, depths, images, voxel_sh, thres, rgbd, **kw):
        if not levels or levels[-1]["grid"].voxel_size != grid.voxel_size:
            levels.append(dict(grid=copy.deepcopy(grid), params=params, depths=depths.cpu().numpy(), thres=thres,
                               rgbd=rgbd, tag=f"p{rgbd}v{grid.num_voxels}"))
        return real(grid, topo, params, cfg, cam, depths, images, voxel_sh, thres, rgbd, **kw)

    intrinsic3d.optimize_level = record
    try:
        engine = intrinsic3d.Intrinsic3D(PIPELINE_REFINEMENT, sensor, kf_ids, cg_iters=PIPELINE_CG_ITERS, device=dev,
                                         prefetch=False)
        engine.refine(fused)
    finally:
        intrinsic3d.optimize_level = real
    if cuda:
        torch.cuda.synchronize()

    x = torch.zeros(16, device=dev)

    def op():
        x.add_(1.0)

    for _ in range(1000):
        op()
    idle = []
    for _ in range(IDLE_OPS):
        t0 = time.perf_counter()
        op()
        idle.append(time.perf_counter() - t0)
    idle_median = statistics.median(idle)
    print(f"main thread's tiny op alone: median {1e6 * idle_median:.2f} us, p99 "
          f"{1e6 * float(np.percentile(idle, 99)):.2f} us, max {1e3 * max(idle):.3f} ms over {IDLE_OPS}; switch "
          f"interval {1e3 * sys.getswitchinterval():.1f} ms", flush=True)

    out = dict(card=smi, idle_op_median_us=1e6 * idle_median, levels=[])
    budget = opt.level_budget(dev)
    for lv in levels:
        grid, params = lv["grid"], lv["params"]
        h, w = lv["depths"].shape[1:]
        rec = dict(level=lv["tag"], voxels=grid.num_voxels, stages={})
        g = grid.clone()  # no memoized tables
        stages = rec["stages"]
        stages["layout"] = stage_convoy(lambda: BlockLayout.build(g), op, idle_median)
        layout = stages["layout"].pop("value")
        inputs = opt.plan_inputs(params, lv["depths"], w, h, lv["rgbd"])
        stages["plan"] = stage_convoy(
            lambda: opt._plan_level(layout, inputs, PIPELINE_REFINEMENT, g.voxel_size, lv["thres"], budget), op,
            idle_median)
        stages["plan"]["reason"] = stages["plan"].pop("value")[1]
        stages["topology"] = stage_convoy(lambda: LevelTopology.build(g), op, idle_median)
        topo = stages["topology"].pop("value")
        stages["statics"] = stage_convoy(lambda: level_static_host(layout, g, topo, None), op, idle_median)
        stages["statics"].pop("value")
        if cuda:
            # what a single-device level on the card builds instead, on the
            # main thread after the join: the statics from the layout
            # (upload, memset and launches; the second of two calls)
            zero_sh = np.zeros((g.num_voxels, 9), np.float32)
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                build_level_static(layout, g, None, zero_sh, dev)
                torch.cuda.synchronize()
                rec["card_statics_s"] = time.perf_counter() - t0
        if lv is not levels[-1]:
            stages["upsample_skeleton"] = stage_convoy(lambda: alg._upsample_skeleton(g), op, idle_median)
            child = stages["upsample_skeleton"].pop("value")[1]
            route = alg._shell_route(child, None, dev)
            stages["shell_inputs"] = stage_convoy(lambda: alg.shell_inputs(child, route), op, idle_median)
            stages["shell_inputs"].pop("value")
            stages["shell_inputs"]["route"] = "dense" if route else "host"
        # each prep whole, as the refinement runs it (the stencil tables on a
        # second thread beside the layout and the plan)
        stages["level_prep"] = stage_convoy(
            lambda: opt.LevelPrep(grid.clone(), None, params, PIPELINE_REFINEMENT, lv["depths"], lv["thres"],
                                  lv["rgbd"], budget=budget).join(), op, idle_median)
        stages["level_prep"].pop("value")
        if lv is not levels[-1]:
            stages["upsample_prep"] = stage_convoy(lambda: alg.UpsamplePrep(g, device=dev).join(), op, idle_median)
            stages["upsample_prep"].pop("value")
        rec["blocks"] = layout.num_blocks
        out["levels"].append(rec)
        print(f"level {lv['tag']}: {grid.num_voxels} voxels, {layout.num_blocks} blocks"
              + (f"; statics built on the card in {rec['card_statics_s']:.4f}s" if cuda else ""), flush=True)
        for name, st in stages.items():
            print(f"  {name}: {st['seconds']:.4f}s on the thread; main thread {st['ops']} ops, median "
                  f"{st['op_median_us']:.2f} us, max {st['op_max_ms']:.3f} ms, convoy {st['convoy_s']:.4f}s "
                  f"({100 * st['convoy_share']:.1f}% of the stage)", flush=True)
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "profile_prefetch.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
