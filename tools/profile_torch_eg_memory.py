#!/usr/bin/env python3
"""Peak device memory per E_g element of the PyTorch port's layouts, on one
GPU: the data `refine.optimizer.plan_eg_layout`'s constants are set from.

    python3 tools/profile_torch_eg_memory.py [--scene bench|orbit|both]

For each scene it builds one (grid, pyramid) level with the planner's exact
frame buckets and reads `torch.cuda.max_memory_allocated` (counters reset
just before) around:
- the device assembly alone, bucketed (the `_EG_ASSEMBLY_BYTES` reading);
- one outer step (`fused_outer_step`: assembly, linearization, the LM/PCG
  solve at the level's settings) one-shot, dense where it fits and bucketed
  (`_EG_DENSE_BYTES_PER_ELEMENT`, `_EG_BUCKET_BYTES_PER_ELEMENT`);
- one bucketed outer step streamed in C = 1, 2, 4, 8 frame chunks, and the
  line peak(C) / elements = persist + transient · ⌈K/C⌉ / K through the two
  least-chunked readings that ran, with every other reading against it
  (`_EG_CHUNK_PERSIST_BYTES`, `_EG_CHUNK_TRANSIENT_BYTES`).
Bytes per element are the whole peak (images, statics and parameters
included, as the planner's budget counts them) over the layout's elements;
the peak above what the level held before the call is printed beside it.
A layout that runs out of memory is reported as such.

Scenes: `bench`, the refinement step of bench.py (`synthetic.BENCH_*`: 8
keyframes at 320x240, voxel 4 mm); `orbit`, the finest level (1 mm, full
resolution) of bench_pipeline.py's 90-frame orbit
(`synthetic.PIPELINE_MANY_KF_DATASET`: keyframes and fusion on the card, 30
keyframes), reached through `Intrinsic3D.refine` with the coarser levels'
solves skipped, so its grid is the upsampled fused one. Prints one line per
reading and the card's name and power limit; writes
`chiprun_out/eg_memory.json`. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
CHUNKS = (1, 2, 4, 8)


class _FinestLevel(Exception):
    """Stops the refinement once the finest level's inputs are captured."""


def bench_level(device):
    """`optimize_level`'s arguments for the bench.py step's problem."""
    from intrinsic3d_torch.synthetic import BENCH_PROBLEM, BENCH_SOLVER, build_sphere_problem

    p = build_sphere_problem(**BENCH_PROBLEM, device=device)
    cfg = dataclasses.replace(p.cfg, lm_steps=BENCH_SOLVER["lm_steps"], schur_globals=True)
    return (p.grid, p.topo, p.params, cfg, p.cam, p.depths, p.images, p.voxel_sh, p.thres_shell, 0), dict(
        cg_iters=BENCH_SOLVER["cg_iters"]
    )


def orbit_finest_level(device):
    """`optimize_level`'s arguments at the finest level of the 90-frame
    orbit's refinement: keyframes and fusion on `device`, then
    `Intrinsic3D.refine` with every coarser level's solve skipped."""
    import torch

    from intrinsic3d_torch.apps import app_fusion, app_keyframes
    from intrinsic3d_torch.refine import intrinsic3d
    from intrinsic3d_torch.refine.optimizer import OptimizeStats
    from intrinsic3d_torch.synthetic import (
        PIPELINE_CG_ITERS,
        PIPELINE_MANY_KF_DATASET,
        PIPELINE_REFINEMENT,
        PIPELINE_SETTINGS,
        build_orbit_dataset,
        pipeline_configs,
    )

    ds = PIPELINE_MANY_KF_DATASET
    sensor = build_orbit_dataset(**ds)
    kcfg, fcfg = pipeline_configs(center=ds["center"], radius=ds["radius"], **PIPELINE_SETTINGS)
    kf_ids = app_keyframes.run(sensor, kcfg, device=device).keyframe_ids()
    fused = app_fusion.run(sensor, fcfg, device=device)
    captured = {}

    def skip_or_capture(grid, topo, params, cfg, cam, depths, images, voxel_sh, thres, rgbd, **kw):
        if grid.voxel_size > 0.0011 or rgbd > 0:
            return params, kw["mu0"], OptimizeStats([], [], [])
        captured["args"] = (grid, topo, params, cfg, cam, depths, images, voxel_sh, thres, rgbd)
        captured["kw"] = dict(cg_iters=kw["cg_iters"])
        raise _FinestLevel

    real = intrinsic3d.optimize_level
    intrinsic3d.optimize_level = skip_or_capture
    try:
        engine = intrinsic3d.Intrinsic3D(PIPELINE_REFINEMENT, sensor, kf_ids, cg_iters=PIPELINE_CG_ITERS,
                                         device=device)
        engine.refine(fused)
    except _FinestLevel:
        pass
    finally:
        intrinsic3d.optimize_level = real
    if "args" not in captured:
        raise RuntimeError("the orbit's refinement never reached its finest level")
    torch.cuda.synchronize()
    return captured["args"], captured["kw"]


def measure(scene: str, args, kw, device) -> dict:
    """The readings of one scene's level (see the module docstring)."""
    import torch

    from intrinsic3d_torch.grid.blocks import BlockLayout
    from intrinsic3d_torch.mathutil import compute_varying_lambda, pyramid_level_to_scale
    from intrinsic3d_torch.refine.assembly import level_topology
    from intrinsic3d_torch.refine.optimizer import plan_eg_layout, prepare_level

    grid, topo, params, cfg, _, depths, images, voxel_sh, thres, rgbd = args
    pyr = pyramid_level_to_scale(rgbd)
    h, w = int(depths.shape[1]), int(depths.shape[2])
    layout = BlockLayout.build(grid)
    fb, _, _ = plan_eg_layout(
        layout, params.poses.cpu().numpy(), params.intr.cpu().numpy().astype(np.float64) * pyr,
        dataclasses.replace(cfg, frame_bucketing="always"), w, h, grid.voxel_size, thres,
        depths.cpu().numpy() if cfg.occlusion_distance > 0.0 else None, budget=float("inf"), device=device,
    )
    lambdas = (cfg.lambda_g, compute_varying_lambda(0, cfg.iterations, cfg.lambda_r0, cfg.lambda_r1),
               compute_varying_lambda(0, cfg.iterations, cfg.lambda_s0, cfg.lambda_s1), cfg.lambda_a)
    topo = level_topology(grid) if topo is None else topo
    dense = prepare_level(grid, topo, voxel_sh, params, cfg, thres, w, h, lambdas, pyr, device, layout=layout)
    k, s, nb, nbc = int(params.poses.shape[0]), layout.block**3, layout.num_blocks, int(fb.shape[1])
    solver = dict(lm_steps=cfg.lm_steps, cg_iters=kw["cg_iters"], schur_globals=cfg.schur_globals,
                  min_pose_obs=cfg.min_pose_obs)
    total = torch.cuda.mem_get_info(device)[1]
    out = dict(scene=scene, keyframes=k, blocks=nb, bucket_blocks=nbc, voxels=grid.num_voxels,
               image=[w, h], dense_elements=k * nb * s, bucket_elements=k * nbc * s, total_bytes=total,
               readings=[])
    print(f"scene {scene}: {grid.num_voxels} voxels, {nb} blocks, K={k}, {w}x{h}; exact buckets {nbc} "
          f"blocks/frame ({100.0 * nbc / nb:.1f}%); elements dense {k * nb * s}, bucketed {k * nbc * s}; "
          f"card memory {total / 1e9:.2f} GB", flush=True)

    def reading(name, elements, fn, chunks=None):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        try:
            res = fn()
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            res = None
        if res is None:
            print(f"  {name}: out of memory at {elements} elements", flush=True)
            out["readings"].append(dict(name=name, chunks=chunks, elements=elements, peak=None))
            return
        del res
        peak = torch.cuda.max_memory_allocated(device)
        print(f"  {name}: peak {peak / 1e9:.3f} GB = {peak / elements:.1f} B/element "
              f"({(peak - base) / elements:.1f} B/element above the {base / 1e9:.3f} GB held before)", flush=True)
        out["readings"].append(dict(name=name, chunks=chunks, elements=elements, peak=peak, base=base))

    bucketed = dense._replace(bmap=torch.as_tensor(fb.astype(np.int64), device=device))
    mu = torch.tensor(1e-4, device=device)
    reading("assembly, bucketed", k * nbc * s, lambda: bucketed.assemble(bucketed.params, depths, images))
    if k * nb * s * 1300 < 0.9 * total:
        reading("outer step, dense one-shot", k * nb * s,
                lambda: dense.outer_step(dense.params, depths, images, mu, **solver))
    for c in CHUNKS:
        lv = bucketed._replace(eg_chunks=c)
        reading(f"outer step, bucketed, {c} chunk{'s' if c > 1 else ''}", k * nbc * s,
                lambda: lv.outer_step(lv.params, depths, images, mu, **solver), chunks=c)

    # the streamed line: through the two least-chunked readings that ran,
    # peak(C)/elements = persist + transient · ⌈K/C⌉/K; a reading above it
    # is printed with its excess (the assembly's own peak is a floor below
    # which streaming cannot go)
    pts = [(-(-k // r["chunks"]) / k, r["peak"] / r["elements"], r["chunks"])
           for r in out["readings"] if r["chunks"] and r["peak"]]
    if len(pts) >= 2:
        (x0, y0, c0), (x1, y1, c1) = pts[:2]
        t = (y0 - y1) / (x0 - x1)
        p = y0 - t * x0
        out["line"] = dict(persist=p, transient=t, through=[c0, c1])
        above = ", ".join(f"C={c} {y - (p + t * x):+.1f} B" for x, y, c in pts[2:])
        print(f"  line through C={c0} and C={c1}: persist {p:.1f} B/element + transient {t:.1f} B per "
              f"chunk-resident element; other readings against it: {above or 'none'}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=("bench", "orbit", "both"), default="both")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_eg_memory: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    from intrinsic3d_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build_all()
    dev = torch.device("cuda")
    results = []
    for scene in ("bench", "orbit") if args.scene == "both" else (args.scene,):
        level_args, kw = bench_level(dev) if scene == "bench" else orbit_finest_level(dev)
        results.append(measure(scene, level_args, kw, dev))
        del level_args
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "eg_memory.json").write_text(json.dumps(dict(card=smi, scenes=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
