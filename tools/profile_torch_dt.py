#!/usr/bin/env python3
"""Time the fused distance-transform kernel (K3) of the PyTorch port over
candidate plans, on one GPU.

    python3 tools/profile_torch_dt.py [--crossover] [--out build/dt_plans.json]

Inputs: the dense window the fusion path hands K3 at bench_pipeline.py's
scale (captured from one `app_fusion.run`), and `chip_smoke.py`'s
411x211x501 sphere-band field, both with 10 sweeps. Every plan (sweeps per
launch S, tile rows, block columns, x-segment) that fits is
held bit for bit against the plain version's output, then timed as device
ms per call (replayed from a CUDA graph). Prints the best plan of each S and input and
the plan `sweep_plan` picks; writes every timing to `--out`. Needs a CUDA
device.

`--crossover` times only `sweep_plan`'s two plans, SMALL_PLAN and
LARGE_PLAN, each held bit for bit, on the window and on sphere-band fields
of the field's shape scaled by CROSSOVER_SCALES: where the second starts to
beat the first is where `sweep_plan` should switch (`LARGE_FROM_VOXELS`).
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CROSSOVER_SCALES = (0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.85, 1.0)


def window_inputs():
    """The (sdf, weight, voxel, iters) the fusion path hands K3."""
    from intrinsic3d_torch.apps import app_fusion
    from intrinsic3d_torch.grid import algorithms
    from intrinsic3d_torch.synthetic import PIPELINE_DATASET, PIPELINE_SETTINGS, build_orbit_dataset, pipeline_configs

    import chip_smoke

    sensor = build_orbit_dataset(**PIPELINE_DATASET)
    _, fcfg = pipeline_configs(center=PIPELINE_DATASET["center"], radius=PIPELINE_DATASET["radius"],
                               **PIPELINE_SETTINGS)
    captured = {}
    restore = chip_smoke.capture_first_call(algorithms, "correct_sdf_dense", captured)
    app_fusion.run(sensor, fcfg)
    restore()
    return captured["correct_sdf_dense"]


def split(iters: int, s: int):
    n = -(-iters // s)
    return tuple(iters // n + (i < iters % n) for i in range(n))


def fits(dt, plan) -> bool:
    return all(plan.tile_z(k) >= 8 and plan.threads(k) <= dt.MAX_THREADS
               and dt.smem_bytes(k, plan.tile_y, plan.cols) <= dt.SMEM_BYTES for k in plan.sweeps)


def candidates(dt, shape, iters):
    """Every (S, tile rows, block columns, x-segment) that fits, with
    columns no wider than the window needs."""
    x, _, z = shape
    for s, cols, ty, seg in itertools.product((1, 2, 3, 4, 5, 6), (32, 64, 96, 128), (2, 4, 6, 8, 12, 16),
                                              (1, 2, 4, 8, 16, 32, 64)):
        if seg > x or cols > 32 * -(-(z + 2 * s) // 32):
            continue
        plan = dt.SweepPlan(split(iters, s), ty, cols, seg)
        if fits(dt, plan):
            yield plan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--crossover", action="store_true",
                    help="time only sweep_plan's two plans, on the window and on fields of CROSSOVER_SCALES")
    ap.add_argument("--out", default=str(REPO / "build" / "dt_plans.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_dt: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from intrinsic3d_torch.ops import build
    from intrinsic3d_torch.ops import distance_transform as dt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build_all(["correct_sdf_dense"])
    for line in build.BUILD_LOGS.get("correct_sdf_dense", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip(), flush=True)

    sdf, weight, voxel, iters = window_inputs()
    fields = ([tuple(max(1, round(f * n)) for n in chip_smoke.DT_FIELD) for f in CROSSOVER_SCALES]
              if args.crossover else [chip_smoke.DT_FIELD])
    inputs = {"window": lambda: (sdf, weight, voxel)}
    for shape in fields:
        tag = "field" if shape == chip_smoke.DT_FIELD else "field " + "x".join(map(str, shape))
        inputs[tag] = lambda shape=shape: (*chip_smoke.sphere_band_field(shape, 0.004, 11), 0.004)
    rows = []
    for tag, make in inputs.items():
        s_in, w_in, vs = make()
        shape = tuple(s_in.shape)
        want_s, want_w = dt.correct_sdf_dense_plain(s_in, w_in, vs, iters)
        b_ms, _ = chip_smoke.bound(16 * s_in.numel(), 0)
        reps = 20 if s_in.numel() < 10**6 else 5
        timed = {}

        def time_plan(plan):
            if plan in timed:
                return timed[plan]
            got_s, got_w = dt._run_plan(s_in, w_in, vs, plan)
            if not (torch.equal(got_s.view(torch.int32), want_s.view(torch.int32)) and torch.equal(got_w, want_w)):
                raise SystemExit(f"MISMATCH {tag} {plan}")
            ms = chip_smoke.graph_ms(lambda: dt._run_plan(s_in, w_in, vs, plan), reps)
            timed[plan] = ms
            rows.append(dict(input=tag, dims=list(shape), S=max(plan.sweeps), tile_y=plan.tile_y, cols=plan.cols,
                             seg=plan.seg, threads=plan.threads(max(plan.sweeps)),
                             launches=len(plan.sweeps), blocks=plan.blocks(shape), ms=ms, bytes_bound_ms=b_ms))
            return ms

        if args.crossover:
            valid = int((w_in > 0).sum())
            small, large = (time_plan(dt.plan_from(shape, iters, base)) for base in (dt.SMALL_PLAN, dt.LARGE_PLAN))
            print(f"{tag}: voxels={s_in.numel()} valid={valid} SMALL_PLAN ms={small:.4f} LARGE_PLAN ms={large:.4f} "
                  f"large/small={large / small:.3f} bytes_bound_ms={b_ms:.4f} "
                  f"sweep_plan takes {'SMALL' if s_in.numel() <= dt.LARGE_FROM_VOXELS else 'LARGE'}", flush=True)
            del want_s, want_w
            continue
        for plan in candidates(dt, shape, iters):
            time_plan(plan)
        best = {}
        for plan, ms in timed.items():
            s = max(plan.sweeps)
            if s not in best or ms < best[s][0]:
                best[s] = (ms, plan)
        for s, (ms, plan) in sorted(best.items()):
            print(f"{tag} best S={s}: ms={ms:.4f} ({100 * b_ms / ms:.1f}% of the bytes bound) {plan} "
                  f"blocks={plan.blocks(shape)}", flush=True)
        chosen = dt.sweep_plan(shape, iters)
        ms = time_plan(chosen)
        print(f"{tag} sweep_plan {chosen}: ms={ms:.4f} bytes_bound_ms={b_ms:.4f} ({100 * b_ms / ms:.1f}%)", flush=True)
        del want_s, want_w
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": smi, "rows": rows}))
    print(f"{len(rows)} plans timed, every one bit-exact; written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
