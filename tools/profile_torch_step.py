#!/usr/bin/env python3
"""Where the time of one refinement outer step of the PyTorch port goes, on
one GPU, at the benchmark's scale (bench.py's configuration,
`intrinsic3d_torch.synthetic.BENCH_*`).

    python3 tools/profile_torch_step.py [--reps 5]

Prints, per phase, the host wall clock around work that ends in a
synchronize (median over `--reps` runs after a warm-up):

- `device_assembly` alone;
- `linearize_block` alone (the E_g reverse pass);
- gradient + Jacobi diagonal (`jtv_block` + `diag_from_lin`);
- one LM acceptance cost (`block_all_residuals`);
- the whole `gn_iteration` (its solve = the rest), with the CG steps and
  LM tries it took;
- the whole `fused_outer_step`.

Then one `fused_outer_step` under `torch.profiler`: the kernels with the
most device time, the device busy share of the step's wall clock, and the
count of device→host reads (`aten::_local_scalar_dense`). Needs a CUDA
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


def timed(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    out, ts = None, []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return out, statistics.median(ts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from intrinsic3d_torch.refine import blockform, solver
    from intrinsic3d_torch.synthetic import BENCH_MU0, BENCH_PROBLEM, BENCH_SOLVER, build_sphere_problem

    prob = build_sphere_problem(**BENCH_PROBLEM, device="cuda")
    level = prob.level()
    params = level.params
    mu = torch.tensor(BENCH_MU0, device="cuda")

    cg_steps = []
    pcg = solver._pcg

    def counting_pcg(*a, **k):
        x, steps = pcg(*a, **k)
        cg_steps.append(steps)
        return x, steps

    solver._pcg = counting_pcg

    (basm, bm), t_asm = timed(lambda: level.assemble(params, prob.depths, prob.images), args.reps)
    _, t_lin = timed(lambda: blockform.linearize_block(params, basm), args.reps)
    _, lin = blockform.linearize_block(params, basm)
    _, t_gd = timed(
        lambda: (blockform.jtv_block(lin, basm, (lin.r0_g, lin.r0_r, lin.r0_s, lin.r0_a)),
                 blockform.diag_from_lin(lin, basm)),
        args.reps,
    )
    del lin
    _, t_cost = timed(lambda: torch.sum(blockform.block_all_residuals(params, basm) ** 2), args.reps)
    cg_steps.clear()
    out, t_gn = timed(lambda: solver.gn_iteration(params, basm, bm, mu, **BENCH_SOLVER, device="cuda"), args.reps)
    steps_per_gn = sum(cg_steps) / (args.reps + 1)
    tries = out[4]

    def outer():
        return level.outer_step(params, prob.depths, prob.images, mu, **BENCH_SOLVER)

    _, t_outer = timed(outer, args.reps)
    solver._pcg = pcg

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    lines = [
        f"card: {smi}",
        f"num_voxels={prob.grid.num_voxels} active_eg={int((basm.eg_w > 0).sum())} reps={args.reps}",
        f"device_assembly        {t_asm * 1e3:9.2f} ms",
        f"linearize_block        {t_lin * 1e3:9.2f} ms",
        f"gradient + diagonal    {t_gd * 1e3:9.2f} ms",
        f"one LM cost            {t_cost * 1e3:9.2f} ms",
        f"gn_iteration           {t_gn * 1e3:9.2f} ms  (tries={tries}, CG steps={steps_per_gn:.1f}; "
        f"solve = {(t_gn - t_lin - t_gd) * 1e3:.2f} ms)",
        f"fused_outer_step       {t_outer * 1e3:9.2f} ms",
    ]

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outer()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return e.self_device_time_total

    # kernels (and memcpy/memset) are the events that run on the device; CPU
    # operators also report the device time of what they launched, so they
    # are left out of the sum
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy_us = sum(dev_us(e) for e in kernels)
    reads = sum(e.count for e in events if e.key == "aten::_local_scalar_dense")
    lines += [
        f"profiled fused_outer_step: wall {wall * 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
        f"({100.0 * busy_us / 1e3 / (wall * 1e3):.1f}%), device->host reads {reads}",
        "top kernels by device time:",
    ]
    for e in sorted(kernels, key=dev_us, reverse=True)[:25]:
        if dev_us(e) > 0:
            lines.append(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:110]}")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
