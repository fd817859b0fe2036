#!/usr/bin/env python3
"""The bench_pipeline refinement on N ranks, one card each, against one card.

    python3 tools/profile_torch_multidevice.py [--ranks N] [--backend nccl|gloo]

Runs keyframes and fusion of bench_pipeline.py's scale on card 0
(`app_keyframes.run`, `app_fusion.run` on `synthetic.PIPELINE_DATASET`), the
single-device refinement of the fused grid twice (`Intrinsic3D.refine` with
`PIPELINE_REFINEMENT`: a warm-up, then the timed run), then
`Intrinsic3D(mesh=)` of the same grid on N spawned ranks, rank r on card r
mod the card count (`parallel.dryrun.refinement_task`). Prints per rank the
refinement seconds, peak memory and collectives, and per level the brick
and halo rows, the outer-iteration median, the peak memory and the first
cost beside the single device's; writes chiprun_out/multidevice_scaling.json.
Needs CUDA devices.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def single_device_refinement(sensor, keyframes, initial, fused) -> dict:
    """`Intrinsic3D.refine` of `fused` on card 0 from the sensor's initial
    poses and camera: the seconds and each level's records."""
    import torch

    from intrinsic3d_torch.refine.intrinsic3d import Intrinsic3D
    from intrinsic3d_torch.synthetic import PIPELINE_CG_ITERS, PIPELINE_REFINEMENT

    poses, cam = initial
    for i, pose in enumerate(poses):
        sensor.set_pose(i, pose)
    sensor.color_cam = cam
    levels, stats = [], {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = Intrinsic3D(PIPELINE_REFINEMENT, sensor, keyframes, cg_iters=PIPELINE_CG_ITERS, stats=stats)
    engine.add_callback(lambda info: levels.append(dict(
        level=f"g{info.grid_level}p{info.pyramid_level}", costs_before=info.stats.costs_before,
        costs_after=info.stats.costs_after, iter_s=info.stats.iter_seconds, peak_bytes=info.stats.peak_bytes)))
    engine.refine(fused, stats=stats)
    torch.cuda.synchronize()
    return dict(total_s=time.perf_counter() - t0, levels=levels, phases=stats)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=None, help="ranks (default: one per card)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_multidevice: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    from intrinsic3d_torch.apps import app_fusion, app_keyframes
    from intrinsic3d_torch.ops import build
    from intrinsic3d_torch.parallel import dryrun
    from intrinsic3d_torch.synthetic import PIPELINE_DATASET, PIPELINE_SETTINGS, build_orbit_dataset, pipeline_configs

    n = args.ranks or torch.cuda.device_count()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    build.build_all()
    sensor = build_orbit_dataset(**PIPELINE_DATASET)
    initial = ([sensor.pose(i).copy() for i in range(sensor.num_frames)], sensor.color_cam)
    kcfg, fcfg = pipeline_configs(center=PIPELINE_DATASET["center"], radius=PIPELINE_DATASET["radius"],
                                  **PIPELINE_SETTINGS)
    keyframes = app_keyframes.run(sensor, kcfg).keyframe_ids()
    fused = app_fusion.run(sensor, fcfg)
    single_device_refinement(sensor, keyframes, initial, fused)  # warm-up
    single = single_device_refinement(sensor, keyframes, initial, fused)
    torch.cuda.empty_cache()
    ranks = dryrun.launch(dryrun.refinement_task, n, backend=args.backend, device="cuda", args=(fused, keyframes))
    print(f"{n} ranks over {args.backend}: refine {[round(r['total_s'], 3) for r in ranks]} s per rank; one card "
          f"{single['total_s']:.3f} s", flush=True)
    for r in ranks:
        calls, secs = r["collectives"]["total_calls"], r["collectives"]["total_s"]
        print(f"  rank {r['rank']}: peak {max(lv['peak_bytes'] for lv in r['levels']) / 1e9:.3f} GB; collectives "
              f"{calls} in {secs:.3f}s {r['collectives']['calls']}; phases "
              + " ".join(f"{k}={v:.4f}" for k, v in r["phases"].items()), flush=True)
    print("  one card: phases " + " ".join(f"{k}={v:.4f}" for k, v in single["phases"].items()), flush=True)
    for lv, ref in zip(ranks[0]["levels"], single["levels"]):
        print(f"  level {lv['level']}: brick {lv['brick_rows']} of {lv['blocks']} rows, halo rows {lv['halo_rows']}; "
              f"outer iteration median {statistics.median(lv['iter_s']):.4f}s (one card "
              f"{statistics.median(ref['iter_s']):.4f}s); peak {lv['peak_bytes'] / 1e9:.3f} GB (one card "
              f"{ref['peak_bytes'] / 1e9:.3f}); first cost {lv['costs_before'][0]:.7f} (one card "
              f"{ref['costs_before'][0]:.7f})", flush=True)
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "multidevice_scaling.json").write_text(json.dumps(dict(
        ranks=n, backend=args.backend, single=single, multi=ranks), indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
