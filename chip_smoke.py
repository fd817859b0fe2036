#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`intrinsic3d_torch`) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `intrinsic3d_torch/csrc/` with nvcc,
then:

1. drives the refinement outer step once at the benchmark's scale (bench.py:
   voxel 0.004 m, 320x240, 8 keyframes, 142,256 voxels) as a warm-up,
   recording the inputs the path hands each kernel;
2. holds every kernel against its plain PyTorch version on those inputs and
   times kernel, plain version and (where one exists) the one PyTorch call
   computing the same function;
3. zeroes the launch counters, drives 5 chained outer iterations through
   `refine.optimizer.fused_outer_step`, and reads the counters (every kernel
   of the path must have run);
4. checks the result on a small problem against the port's plain CPU path
   (which the repo's tests hold against the JAX package).

Prints the card (`nvidia-smi` name and power limit), one line per phase, a
JSON `{"kernels": [...]}` line, and as the last line
`{"ok": true, "device": {...}}`. Exits non-zero on any failure, and when no
CUDA device is available. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and the float32
# rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# float operations per ACTIVE element, counted from csrc/bicubic_rows.cu:
# 2×(weight polynomials, ~10 ops each) + 16 tap FMAs + 4 row FMAs (an FMA is
# 2 ops) for the value; 4 weight polynomials + 2×16 + 3×4 FMAs with the
# derivatives
BICUBIC_OPS = {"fwd": 2 * 10 + 2 * (16 + 4), "fwdgrad": 4 * 10 + 2 * (2 * 16 + 3 * 4)}
CHAINED_ITERS = 5


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean ms per call of `fn` issued from Python (CUDA events around `reps`
    back-to-back calls after a warm-up): device time plus whatever launch
    gaps the host leaves."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device ms per call of `fn`: `reps` calls captured in one CUDA
    graph and replayed, so no host launch gap enters the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def needed_bytes(images, m: int, n_act: int, out_bytes: int) -> int:
    """Bytes a masked per-element sampler must move: every element's 4 B
    `active` flag and its `out_bytes` of output, the three 4 B index or
    coordinate arrays of the active elements only (an inactive element needs
    nothing else), and the image stack once."""
    return m * (4 + out_bytes) + n_act * 12 + images.numel() * images.element_size()


def capture_first_call(module, name: str, store: dict):
    """Wrap `module.name` so its first call's arguments are kept (cloned)."""
    import torch

    orig = getattr(module, name)

    def wrapper(*args):
        if name not in store:
            store[name] = tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args)
        return orig(*args)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, orig)


def check_kernels(captured: dict) -> list:
    """Phase 1: each kernel against its plain version on the path's inputs."""
    import torch

    from intrinsic3d_torch.ops import bicubic

    records = []
    images, fid, x, y, active = captured["bicubic_rows"]
    m = x.shape[0]
    n_act = int((active > 0).sum())
    val_p, ddx_p, ddy_p = bicubic.bicubic_rows_plain(images, fid, x, y, active)

    xg, yg = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    out = bicubic.bicubic_rows(images, fid, xg, yg, active)
    gx, gy = torch.autograd.grad(out, (xg, yg), grad_outputs=torch.ones_like(out))
    out = out.detach()
    fwd = bicubic.bicubic_rows(images, fid, x, y, active)
    torch.cuda.synchronize()

    def errs(pairs):
        abs_err = max(float((a - b).abs().max()) for a, b in pairs)
        rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in pairs)
        return abs_err, rel

    for tag, pairs in (("fwdgrad", [(out, val_p), (gx, ddx_p), (gy, ddy_p)]), ("fwd", [(fwd, val_p)])):
        for got, want in pairs:
            if not torch.isfinite(got).all():
                fail(f"bicubic_rows_{tag}: non-finite output")
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
        abs_err, rel = errs(pairs)
        with_grad = tag == "fwdgrad"
        kernel = lambda: bicubic._launch_bicubic(images, fid, x, y, active, with_grad)  # noqa: E731
        ms, call_ms = graph_ms(kernel), cuda_ms(kernel)
        plain_ms = graph_ms(lambda: bicubic.bicubic_rows_plain(images, fid, x, y, active))
        b_ms, b_by = bound(needed_bytes(images, m, n_act, 12 if with_grad else 4), n_act * BICUBIC_OPS[tag])
        log(f"  bicubic_rows_{tag}: M={m} active={n_act} max_abs_err={abs_err:.3e} max_rel_err={rel:.3e} "
            f"ms={ms:.4f} call_ms={call_ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
        records.append(dict(
            name=f"bicubic_rows_{tag}", route="cuda", source="intrinsic3d_torch/csrc/bicubic_rows.cu",
            replaces="intrinsic3d_tpu/ops/pallas/bicubic.py:" + ("490" if with_grad else "473"),
            max_abs_err=abs_err, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None,
        ))

    depths, fid, yi, xi, active = captured["nearest_rows"]
    m = active.shape[0]
    n_act = int((active > 0).sum())
    got = bicubic.nearest_rows(depths, fid, yi, xi, active)
    want = bicubic.nearest_rows_plain(depths, fid, yi, xi, active)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("nearest_rows differs from its plain version")
    # the yardstick: PyTorch's advanced-index gather (int32 indices), masked
    lib = lambda: depths[fid, yi, xi] * (active > 0)  # noqa: E731
    if not torch.equal(lib(), want):
        fail("nearest_rows yardstick differs")
    kernel = lambda: bicubic._launch_nearest(depths, fid, yi, xi, active)  # noqa: E731
    ms, call_ms = graph_ms(kernel), cuda_ms(kernel)
    plain_ms = graph_ms(lambda: bicubic.nearest_rows_plain(depths, fid, yi, xi, active))
    library_ms = graph_ms(lib)
    b_ms, b_by = bound(needed_bytes(depths, m, n_act, 4), 0)
    log(f"  nearest_rows: M={m} active={n_act} max_abs_err=0 ms={ms:.4f} "
        f"call_ms={call_ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by})")
    records.append(dict(
        name="nearest_rows", route="cuda", source="intrinsic3d_torch/csrc/nearest_rows.cu",
        replaces="intrinsic3d_tpu/ops/pallas/bicubic.py:690", max_abs_err=0.0, ms=ms, call_ms=call_ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
    ))
    return records


def small_problem_agrees() -> None:
    """Phase 4: two chained outer steps on a small problem, on the card and
    through the plain CPU path, at converged-solve settings."""
    import torch

    from intrinsic3d_torch.synthetic import build_sphere_problem

    traj = {}
    for device in ("cuda", "cpu"):
        prob = build_sphere_problem(
            voxel_size=0.02, image_size=(64, 48), num_frames=2, num_observations=2,
            perturb_sdf=0.002, perturb_albedo=0.05, device=device,
        )
        level = prob.level()
        p, mu, costs = level.params, torch.tensor(0.3, device=device), []
        for _ in range(2):
            p, c0, c1, mu, tries = level.outer_step(
                p, prob.depths, prob.images, mu, lm_steps=3, cg_iters=200, cg_eta=1e-8,
                schur_globals=True, cg_coeff_dtype="float32",
            )
            costs.append((float(c0), float(c1), tries))
        traj[device] = costs
    log(f"  small problem: cuda {traj['cuda']} cpu {traj['cpu']}")
    for (a0, a1, at), (b0, b1, bt) in zip(traj["cuda"], traj["cpu"]):
        if at != bt or abs(a0 - b0) > 1e-3 * abs(b0) or abs(a1 - b1) > 1e-3 * abs(b1):
            fail(f"small-problem trajectory on the card {traj['cuda']} differs from the CPU path {traj['cpu']}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (REPO / "intrinsic3d_torch" / "csrc").is_dir():
        print(f"chip_smoke: the intrinsic3d_torch package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from intrinsic3d_torch import observations
    from intrinsic3d_torch.ops import bicubic, build
    from intrinsic3d_torch.refine import residuals
    from intrinsic3d_torch.refine.solver import gn_iteration
    from intrinsic3d_torch.synthetic import BENCH_MU0, BENCH_PROBLEM, BENCH_SOLVER, build_sphere_problem

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.build_all()
    log(f"phase build: nvcc for {list(build.SOURCES)} in {time.perf_counter() - t0:.1f}s")
    for name, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")

    # --- bench-scale problem and warm-up outer iteration (records kernel inputs)
    dev = "cuda"
    t0 = time.perf_counter()
    prob = build_sphere_problem(**BENCH_PROBLEM, device=dev)
    level = prob.level()
    log(f"phase setup: num_voxels={prob.grid.num_voxels} num_blocks={level.layout.num_blocks} "
        f"frames={prob.images.shape[0]} in {time.perf_counter() - t0:.1f}s")

    captured = {}
    restore = [
        capture_first_call(residuals, "bicubic_rows", captured),
        capture_first_call(observations, "nearest_rows", captured),
    ]
    t0 = time.perf_counter()
    basm, bmasks = level.assemble(level.params, prob.depths, prob.images)
    n_active = int((basm.eg_w > 0).sum())
    mu = torch.tensor(BENCH_MU0, device=dev)
    _, c0, c1, _, tries = gn_iteration(level.params, basm, bmasks, mu, **BENCH_SOLVER, device=dev)
    torch.cuda.synchronize()
    for r in restore:
        r()
    del basm, bmasks
    log(f"phase warmup: active_eg={n_active} cost {float(c0):.6f} -> {float(c1):.6f} tries={tries} "
        f"in {time.perf_counter() - t0:.2f}s")
    if set(captured) != {"bicubic_rows", "nearest_rows"}:
        fail(f"the warm-up did not reach every kernel: {sorted(captured)}")

    # --- phase 1: kernels against their plain versions on the path's inputs
    records = check_kernels(captured)
    del captured
    log("phase kernels: every kernel agrees with its plain version")

    # --- phase 2: chained outer iterations; counts zeroed just before. One
    # discarded outer step first lets the allocator settle after the
    # kernel timings (their CUDA graphs hold private memory pools).
    level.outer_step(level.params, prob.depths, prob.images, torch.tensor(BENCH_MU0, device=dev), **BENCH_SOLVER)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bicubic.reset_launches()
    p, mu, iter_s = level.params, torch.tensor(BENCH_MU0, device=dev), []
    for it in range(CHAINED_ITERS):
        t0 = time.perf_counter()
        p, c0, c1, mu, tries = level.outer_step(p, prob.depths, prob.images, mu, **BENCH_SOLVER)
        c0, c1 = float(c0), float(c1)
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t0)
        log(f"  outer {it}: cost {c0:.6f} -> {c1:.6f} tries={tries} mu={float(mu):.3e} {iter_s[-1]:.3f}s")
        if not (all(torch.isfinite(f).all() for f in p) and torch.isfinite(mu) and
                c0 == c0 and c1 == c1 and abs(c0) != float("inf") and abs(c1) != float("inf")):
            fail(f"non-finite values at outer iteration {it}")
        if c1 > c0:
            fail(f"outer iteration {it}: accepted cost {c1} above {c0}")
    launches = dict(bicubic.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase slice: {CHAINED_ITERS} outer iterations, median {statistics.median(iter_s):.4f}s "
        f"(min {min(iter_s):.4f}s, max {max(iter_s):.4f}s), launches {launches}, peak memory {peak_gb:.2f} GB")
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was never launched on the main path")
    for r in records:
        r["launches"] = launches[r["name"]]
        r["status"] = "ok"

    # --- phase 3: the result on a small problem against the plain CPU path
    small_problem_agrees()
    log("phase check: the card's trajectory matches the plain CPU path")

    kernels = {"kernels": records}
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
