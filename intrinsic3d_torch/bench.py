"""Gauss-Newton voxel-residual throughput of the port on one device: the
twin of the JAX package's `bench.py`.

    python -m intrinsic3d_torch.bench

Builds `bench.py`'s synthetic joint-refinement problem (`synthetic.BENCH_*`:
a shell grid around an analytic sphere at 4 mm, 8 keyframes at 320×240, 5
observations, perturbed SDF and albedo), counts its active E_g elements
through the flat-table assembly (`SphereProblem.assemble`, as `bench.py`
does), then times full outer iterations of the production step — device
assembly + one relinearize→solve→accept damped-GN step with the globals
Schur-eliminated (`LevelSetup.outer_step`): one warm-up, then 3 chained
iterations from the start point, the device synchronized at the end.

The last line of standard output is `bench.py`'s JSON line with its keys
and its accounting: `gn_voxel_residual_evals_per_s` counts, per outer
iteration, 1 linearization + the 29-parameter Jacobi diagonal + (2·cg
J-products + 1 cost evaluation) per LM try, in units of one E_g
residual+Jacobian evaluation, over the active elements; `vs_baseline` is
against the same 1e6 evaluations/s estimate of the reference's Ceres on 8
CPU threads. `detail.device` names the card (or "cpu").
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from intrinsic3d_torch.config import RefinementConfig
from intrinsic3d_torch.device import resolve_device
from intrinsic3d_torch.synthetic import BENCH_MU0, BENCH_PROBLEM, BENCH_SOLVER, build_sphere_problem

# the JAX package's estimate of the reference's Ceres CPU residual+Jacobian
# throughput (8 threads × ~125k evaluations/s)
REFERENCE_CPU_EVALS_PER_S = 1.0e6
ITERS = 3


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, device="cuda") -> dict:
    """Run the benchmark on `device` (the card unless asked; raises without
    one), print its JSON line and return it as a dict."""
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)  # no flags, as bench.py
    dev = resolve_device(device)
    cfg = RefinementConfig(
        num_observations=BENCH_PROBLEM["num_observations"],
        occlusion_distance=0.02,
        fix_poses=False,
        fix_intrinsics=False,
        fix_distortion=False,
    )
    prob = build_sphere_problem(**BENCH_PROBLEM, cfg=cfg, device=dev)
    asm_t, _ = prob.assemble()
    n_active = int((asm_t.eg_w > 0).sum())
    del asm_t

    level = prob.level()  # raw λ = (λ_g, 10, 10, λ_a), as bench.py sets them

    def outer_iteration(params, mu):
        return level.outer_step(params, prob.depths, prob.images, mu, **BENCH_SOLVER)

    mu0 = torch.tensor(BENCH_MU0, dtype=torch.float32, device=dev)
    outer_iteration(level.params, mu0)  # warm-up
    _sync(dev)

    params, mu, tries_list = level.params, mu0, []
    t0 = time.perf_counter()
    for _ in range(ITERS):
        params, _, _, mu, tries = outer_iteration(params, mu)
        tries_list.append(int(tries))
    _sync(dev)
    dt = time.perf_counter() - t0
    tries_total = sum(tries_list)

    cg_iters = BENCH_SOLVER["cg_iters"]
    evals_per_iter = 1 + 29 + (2 * cg_iters + 1) * (tries_total / ITERS)
    throughput = n_active * evals_per_iter * ITERS / dt
    result = {
        "metric": "gn_voxel_residual_evals_per_s",
        "value": round(throughput, 1),
        "unit": "E_g residual+Jacobian evals/s/chip",
        "vs_baseline": round(throughput / REFERENCE_CPU_EVALS_PER_S, 2),
        "detail": {
            "active_eg_residuals": n_active,
            "num_voxels": prob.grid.num_voxels,
            "outer_iteration_s": round(dt / ITERS, 4),
            "includes_device_assembly": True,
            "cg_iters": cg_iters,
            "mean_lm_tries": round(tries_total / ITERS, 2),
            "device": device_name(dev),
        },
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
