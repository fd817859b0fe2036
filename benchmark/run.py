"""The benchmark of the PyTorch/CUDA port on one card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: claim the card, load the kernels and the native host library
(built into `build/intrinsic3d_torch/` of this checkout on the first run),
render the cell's capture on the card from the seed and hand it to the
program as its in-memory sensor, then warm up with the cell's job kind (by
default one job cut to the coarsest grid level; `benchmark/jobs.py`). The
window is the kind's; by default a closed loop with one job in flight, which
starts a new job while `--seconds` have not passed and never cuts one short.
After the window the outputs each job kept are held against the plain
reference (`benchmark/check.py`), stage by stage. The last line of standard output is
the result; the numbers compared, each beside its limit, are the last lines
of standard error and the result's last key.

`--trace 1` passes `stats=` to the engine (which then synchronizes the card
at every phase end) and runs `torch.profiler` over the window; it reports
the cell's per-layer metrics. `--trace 0` reports its end-to-end metrics.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

# the port's libraries must not load JAX through a library of their own
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "intrinsic3d_tpu")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", root=None) -> dict:
    """One run: set-up, window, check. Returns the result dict. `device`
    and `root` let the benchmark's own tests run it on the CPU at a small
    size."""
    import numpy as np
    import torch

    from benchmark import check, harness
    from benchmark.trace import Trace, busy_seconds, named_gaps, top_ops, window_of

    harness.START = T_START
    log = harness.log
    root = harness.ROOT if root is None else root
    cell = harness.load_cell(workload, root)
    kind = cell.kind
    dev = torch.device(device)

    # set-up
    harness.load_program(dev)
    log("port imported, kernels and native library loaded")
    cap = harness.prepare(cell, seed, dev)
    log("capture rendered and handed over")
    scratch = tempfile.mkdtemp(prefix="i3d_bench_")
    rec = harness.Recorder()
    rec.install()
    try:
        kind.warm_up(cell, cap, dev, rec)
        harness.sync(dev)
        setup_s = time.perf_counter() - T_START
        log(f"set-up {setup_s:.3f}s; window of {seconds}s on {device_name(dev)}")

        # the window
        tr = Trace() if trace else None
        if tr is not None:
            tr.open(dev.type == "cuda")
        t0 = time.perf_counter()
        jobs = kind.window(cell, cap, dev, rec, trace, scratch, seconds)
        window_s = time.perf_counter() - t0
        if tr is not None:
            tr.close()
        peak = max(j.peak_bytes for j in jobs)
    finally:
        rec.uninstall()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check, after the window
    frames_ref = check.Frames(cap.frames, cell.config, dev)
    limits = dict(cell.config["limits"])
    worst, failed = {}, 0
    for n, j in enumerate(jobs):
        r = kind.readings(j, frames_ref, cell)
        if j.refined is not None:
            log(f"job {n + 1}: {j.seconds:.3f}s, surface error median "
                f"{float(np.median(check.surface_errors(j.refined, cell.config['scene']))) * 1e6:.2f} um")
        verdict = check.judge(r, limits)
        # a job with nothing checked is not a correct one
        failed += not verdict or not all(ok for _, _, ok in verdict.values())
        for k, v in r.items():
            worst[k] = max(worst.get(k, float("-inf")), v)
    written = sum(p.stat().st_size for p in Path(scratch).rglob("*") if p.is_file())
    log(f"the jobs wrote {written} bytes")
    shutil.rmtree(scratch, ignore_errors=True)
    verdict = check.judge(worst, limits)
    correct = failed == 0 and all(ok for _, _, ok in verdict.values())

    ctx = SimpleNamespace(cell=cell, jobs=jobs, window_s=window_s, setup_s=setup_s, peak_bytes=peak,
                          device=None, host=None, traced=(None if tr is None else window_of(tr.host)))
    metrics_out, dev_info, breakdown = {}, {}, None
    if tr is not None and ctx.traced is not None:
        ctx.device, ctx.host = tr.device, tr.host
        lo, hi = ctx.traced
        dev_info = dict(busy_s=busy_seconds(tr.device, lo, hi), window_s=hi - lo)
        breakdown = dict(device_ops=top_ops(tr.device), idle_gaps=named_gaps(tr.device, tr.host, lo, hi))
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = harness.load_metric(m["name"], root).read(ctx)
        if v is not None:
            metrics_out[m["name"]] = {"value": float(v), "unit": m["unit"]}

    result = {
        "correct": bool(correct),
        "attempted": len(jobs),
        "failed": int(failed),
        "metrics": metrics_out,
        "device": dict(platform="gpu" if dev.type == "cuda" else "cpu", kind=device_name(dev),
                       count=1, memory_peak_bytes=int(peak), **dev_info),
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim, _) in verdict.items()}
    return result


def device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
