#!/usr/bin/env python3
"""Where the time of the PyTorch port's refinement goes, on one GPU, at
bench_pipeline.py's scale (stage 3 at its defaults,
`intrinsic3d_torch.synthetic.PIPELINE_REFINEMENT`, from the port's own
keyframes and fusion of the 30-frame orbit).

    python3 tools/profile_torch_refine.py [--no-profile]

Runs keyframes + fusion on the card, then `Intrinsic3D.refine` from the
sensor's initial poses three times: a warm-up (the first run in a process
pays the CUDA libraries' start-up), a timed run (host wall clock of every
phase, no synchronize at a phase's end, and per (grid, pyramid)
level its size, plan, setup and outer-iteration seconds and peak memory),
and a run under `torch.profiler` (its wall clock, the device busy share and
the kernels with the most device time). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-profile", action="store_true", help="skip the run under torch.profiler")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_refine: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from intrinsic3d_torch.apps import app_fusion, app_keyframes
    from intrinsic3d_torch.refine.intrinsic3d import Intrinsic3D
    from intrinsic3d_torch.synthetic import (
        PIPELINE_CG_ITERS,
        PIPELINE_DATASET,
        PIPELINE_REFINEMENT,
        PIPELINE_SETTINGS,
        build_orbit_dataset,
        pipeline_configs,
    )

    sensor = build_orbit_dataset(**PIPELINE_DATASET)
    poses0 = [sensor.pose(i).copy() for i in range(sensor.num_frames)]
    cam0 = sensor.color_cam
    kcfg, fcfg = pipeline_configs(center=PIPELINE_DATASET["center"], radius=PIPELINE_DATASET["radius"],
                                  **PIPELINE_SETTINGS)
    kf_ids = app_keyframes.run(sensor, kcfg).keyframe_ids()
    fused = app_fusion.run(sensor, fcfg)

    def refine(stats=None, levels=None):
        for i, pose in enumerate(poses0):
            sensor.set_pose(i, pose)
        sensor.color_cam = cam0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = Intrinsic3D(PIPELINE_REFINEMENT, sensor, kf_ids, cg_iters=PIPELINE_CG_ITERS, stats=stats)
        if levels is not None:
            engine.add_callback(lambda i: levels.append((i.grid_level, i.pyramid_level, i.grid.num_voxels, i.stats)))
        engine.refine(fused, stats=stats)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    warm = refine()
    stats, levels = {}, []
    total = refine(stats, levels)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    lines = [f"card: {smi}", f"keyframes {len(kf_ids)}, fused voxels {fused.num_voxels}; refinement {total:.3f} s "
             f"(warm-up run {warm:.3f} s)"]
    for name, sec in stats.items():
        lines.append(f"  {name:26s} {sec:9.4f} s  {100.0 * sec / total:5.1f}%")
    lines.append(f"  {'(phases not listed)':26s} {total - sum(stats.values()):9.4f} s")
    for g, p, nvox, st in levels:
        lines.append(
            f"level g{g}p{p}: voxels {nvox}, blocks {st.num_blocks}, elements {st.elements}, {st.reason}; setup "
            f"{st.setup_seconds:.3f} s, outer iteration median {statistics.median(st.iter_seconds):.4f} s, "
            f"tries {sum(st.tries)}, peak {st.peak_bytes / 1e9:.2f} GB ({st.peak_bytes / st.elements:.0f} B/element)"
        )

    if not args.no_profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = refine()
        events = prof.key_averages()

        def dev_us(e):
            return e.self_device_time_total

        # kernels and copies run on the device; CPU operators also report the
        # device time of what they launched, so they are left out of the sum
        kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
        busy_us = sum(dev_us(e) for e in kernels)
        reads = sum(e.count for e in events if e.key == "aten::_local_scalar_dense")
        lines += [
            f"profiled refinement: wall {wall:.3f} s, device busy {busy_us / 1e6:.3f} s "
            f"({100.0 * busy_us / 1e6 / wall:.1f}%), device->host reads {reads}",
            "top kernels by device time:",
        ]
        for e in sorted(kernels, key=dev_us, reverse=True)[:25]:
            if dev_us(e) > 0:
                lines.append(f"  {dev_us(e) / 1e3:10.3f} ms  x{e.count:<7d} {e.key[:110]}")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
