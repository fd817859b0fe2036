#!/usr/bin/env python3
"""Where the time of keyframe selection and TSDF fusion of the PyTorch port
goes, on one GPU, at bench_pipeline.py's scale (stages 1 and 2 at its
defaults, `intrinsic3d_torch.synthetic.PIPELINE_*`).

    python3 tools/profile_torch_fusion.py [--reps 5]

Prints the host wall clock of `app_keyframes.run` and of each phase of
`app_fusion.run` (the device synchronized at every phase end; median over
`--reps` runs after a warm-up), then one keyframes + fusion run under
`torch.profiler`: its wall clock, the device busy share, the count of
device→host reads and the kernels with the most device time. Needs a CUDA
device.
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
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_fusion: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from intrinsic3d_torch.apps import app_fusion, app_keyframes
    from intrinsic3d_torch.synthetic import PIPELINE_DATASET, PIPELINE_SETTINGS, build_orbit_dataset, pipeline_configs

    sensor = build_orbit_dataset(**PIPELINE_DATASET)
    kcfg, fcfg = pipeline_configs(center=PIPELINE_DATASET["center"], radius=PIPELINE_DATASET["radius"],
                                  **PIPELINE_SETTINGS)

    def once(stats):
        t0 = time.perf_counter()
        app_keyframes.run(sensor, kcfg)
        torch.cuda.synchronize()
        stats["keyframes"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        app_fusion.run(sensor, fcfg, stats=stats)
        stats["fusion"] = time.perf_counter() - t0

    once({})
    runs = []
    for _ in range(args.reps):
        runs.append({})
        once(runs[-1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    lines = [f"card: {smi}", f"frames={sensor.num_frames} dims={runs[0]['dims']} allocated={runs[0]['allocated']} "
             f"kept={runs[0]['kept']} reps={args.reps}"]
    for name in ("keyframes", "fusion") + app_fusion.PHASES:
        lines.append(f"{name:22s} {statistics.median(r[name] for r in runs) * 1e3:9.2f} ms")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        once({})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return e.self_device_time_total

    # kernels and copies run on the device; CPU operators also report the
    # device time of what they launched, so they are left out of the sum
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy_us = sum(dev_us(e) for e in kernels)
    reads = sum(e.count for e in events if e.key == "aten::_local_scalar_dense")
    lines += [
        f"profiled keyframes + fusion: wall {wall * 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
        f"({100.0 * busy_us / 1e3 / (wall * 1e3):.1f}%), device->host reads {reads}",
        "top kernels by device time:",
    ]
    for e in sorted(kernels, key=dev_us, reverse=True)[:20]:
        if dev_us(e) > 0:
            lines.append(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:110]}")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
