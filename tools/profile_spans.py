#!/usr/bin/env python3
"""Where the card waits in a traced benchmark run, by the program's own spans.

    python3 tools/profile_spans.py [--workload orbit10kf.reconstruct] [--seed N] [--seconds S] [--tag NAME]

Runs `benchmark.run.execute` as `python3 -m benchmark.run ... --trace 1`
does (the same set-up, window, profiler and check) and reads the same
profile once more, writing `chiprun_out/spans_<tag>_<seed>.json`:

- `span_us`: the cost of one `timer.span` (and of a bare `record_function`)
  with no profiler running, timed on this host before the run, and
  `spans_a_job`, the program's spans a job in the traced window;
- `result`: the benchmark's result (metrics, breakdown, checks) and
  `job_s`, each job's seconds (its `job` mark);
- `gaps`: the window's ten longest device gaps, each named by the innermost
  program span over its middle (the benchmark's `trace.host_at` names it by
  the shortest host range of any kind);
- `device_ops`: the device operations with the most time, each put down to
  the program spans and the torch operations whose launches took most of
  it, through the profiler's correlation ids (a kernel's runtime call, and
  the innermost span and operation around that call on the main thread);
- `reads`: the scalar reads (`aten::_local_scalar_dense`) inside the
  `solve[...]` ranges against the levels' `OptimizeStats.host_reads`, and
  the runtime's synchronizing calls there by the torch operation that made
  them;
- `idle_split`: the window's idle seconds inside the `solve[...]` ranges,
  inside the `refine` marks outside them and outside the marks, against
  `device.idle_pct` times the window;
- `device_span_names`: device intervals that bear a program span's name.

A parent tree without the spans runs it too (its spans read nothing).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import json
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# the program's span names (`intrinsic3d_torch/timer.py::span` callers)
SPAN = re.compile(r"(pyramids|initial_recolor|(sparsify|topology|upsample)\[g\d+\]|(svsh|recolor)\[g\d+p\d+\]"
                  r"|(level_setup|solve)\[p\d+v\d+\]|join\[.+\]|solve\.assemble|solve\.lm_try|upsample\.fields)$")


def span_cost(n: int = 20000) -> dict:
    """Microseconds of one span (None in a tree without them) and one bare
    `record_function`, no profiler."""
    from torch.profiler import record_function

    from intrinsic3d_torch import timer

    out = {"span": None}
    for _ in range(2):  # the second pass is kept
        if hasattr(timer, "span"):
            t0 = time.perf_counter()
            for _ in range(n):
                with timer.span("solve.lm_try"):
                    pass
            out["span"] = (time.perf_counter() - t0) / n * 1e6
        t0 = time.perf_counter()
        for _ in range(n):
            with record_function("solve.lm_try"):
                pass
        out["record_function"] = (time.perf_counter() - t0) / n * 1e6
    return out


class Innermost:
    """The innermost of nested intervals at a time: the intervals cut into
    disjoint segments, each labelled with the interval opened last and still
    open."""

    def __init__(self, intervals):
        edges = sorted([(s, 1, i) for i, (s, _, _) in enumerate(intervals)]
                       + [(e, 0, i) for i, (_, e, _) in enumerate(intervals)])
        self.starts, self.labels = [], []
        open_, t = [], None
        for when, is_start, i in edges:
            if t is not None and when > t and open_:
                self.starts.append(t)
                self.labels.append((when, intervals[open_[-1]][2]))
            if is_start:
                open_.append(i)
            elif i in open_:
                open_.remove(i)
            t = when

    def at(self, t: float):
        k = bisect.bisect_right(self.starts, t) - 1
        if k < 0:
            return None
        end, label = self.labels[k]
        return label if t < end else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="orbit10kf.reconstruct")
    ap.add_argument("--seed", type=int, default=2**31 + 14)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_spans: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from benchmark import run
    from benchmark import trace as btrace

    cost = span_cost()
    kept = {}
    real_open = btrace.Trace.open

    def keep_open(self, cuda=True):
        real_open(self, cuda)
        kept["trace"], kept["prof"] = self, self._prof

    btrace.Trace.open = keep_open
    try:
        res = run.execute(args.workload, args.seed, args.seconds, True)
    finally:
        btrace.Trace.open = real_open
    tr = kept["trace"]
    events = list(kept["prof"].profiler.kineto_results.events())

    def sec(e):
        s = e.start_ns() * 1e-9
        return s, s + e.duration_ns() * 1e-9

    host = [e for e in events if "CUDA" not in str(e.device_type())]
    jobs = [(*sec(e), "job") for e in host if e.name() == "job"]
    main_tid = next(e.start_thread_id() for e in host if e.name() == "job")
    on_main = [e for e in host if e.start_thread_id() == main_tid]
    spans = [(*sec(e), e.name()) for e in on_main if e.is_user_annotation() and SPAN.match(e.name())]
    solves = [s for s in spans if s[2].startswith("solve[")]
    refines = [(*sec(e), "refine") for e in on_main if e.name() == "refine"]
    ops = [(*sec(e), e.name()) for e in on_main if e.name().startswith("aten::")]
    lo, hi = btrace.window_of(tr.host)
    n_jobs = len(jobs)

    span_at = Innermost(spans)
    gaps = [dict(seconds=e - s, span=span_at.at(0.5 * (s + e)) or "no program span",
                 host_at=btrace.host_at(tr.host, 0.5 * (s + e)))
            for s, e in btrace.idle_gaps(tr.device, lo, hi)[:10]]

    # device operations put down to the spans and operations that launched
    # them: a kernel's `linked_correlation_id` is the correlation id of the
    # host event (the torch operation or its runtime call) that launched it
    launch_at = {}
    for e in sorted(host, key=lambda e: e.start_ns()):
        if e.correlation_id():
            launch_at[e.correlation_id()] = (sec(e)[0], e.name())
    op_at = Innermost(ops)
    by_op = defaultdict(float)
    by_span, by_torch = defaultdict(lambda: defaultdict(float)), defaultdict(lambda: defaultdict(float))
    for e in events:
        if "CUDA" not in str(e.device_type()) or e.is_user_annotation() or e.name() in btrace.MARKS:
            continue
        name, dur = e.name(), e.duration_ns() * 1e-9
        by_op[name] += dur
        if e.linked_correlation_id() not in launch_at:
            continue
        t, launcher = launch_at[e.linked_correlation_id()]
        by_span[name][span_at.at(t) or "no program span"] += dur
        by_torch[name][launcher if launcher.startswith("aten::") else (op_at.at(t) or "no torch op")] += dur

    def top(d, n=3):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]

    device_ops = [dict(name=k[:160], seconds=v, spans=top(by_span[k]), torch_ops=top(by_torch[k]))
                  for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:10]]

    # the solve's scalar reads against the program's count
    u_solves = btrace.union(solves)
    in_solves = lambda s: any(a <= s < b for a, b in u_solves)  # noqa: E731
    scalar = sum(1 for e in on_main if e.name() == "aten::_local_scalar_dense" and in_solves(sec(e)[0]))
    syncs, sync_ops = defaultdict(int), defaultdict(int)
    for e in on_main:
        t = sec(e)[0]
        if e.name().startswith(("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")) and in_solves(t):
            syncs[e.name()] += 1
            if e.name().startswith("cudaStreamSynchronize"):
                sync_ops[op_at.at(t) or "no torch op"] += 1
    reads = dict(local_scalar_dense_in_solves=scalar,
                 host_reads=res["metrics"].get("solve.host_reads", {}).get("value", 0.0) * n_jobs,
                 runtime_calls_in_solves=dict(syncs), stream_syncs_by_op=top(sync_ops, 10))

    # the window's idle seconds in three parts
    def idle_in(parts):
        return sum((e - s) - btrace.busy_seconds(tr.device, s, e) for s, e in parts)

    u_refine = btrace.union(refines, lo, hi)
    in_solve = idle_in(btrace.union(solves, lo, hi))
    in_refine = sum(idle_in([(a, b) for a, b in btrace.idle_gaps(solves, s, e)]) for s, e in u_refine)
    outside = idle_in(btrace.idle_gaps(refines, lo, hi))
    total = (hi - lo) - btrace.busy_seconds(tr.device, lo, hi)
    idle_split = dict(solves=in_solve, level_stages=in_refine, outside_refine=outside, sum=in_solve + in_refine
                      + outside, window_idle=total, device_idle_pct_x_window=res["metrics"].get(
                          "device.idle_pct", {}).get("value", float("nan")) / 100.0 * (hi - lo))

    out = dict(
        workload=args.workload, seed=args.seed, tag=args.tag, card=torch.cuda.get_device_name(0),
        torch=torch.__version__, span_us=cost, spans_a_job=len(spans) / max(n_jobs, 1),
        span_counts={k: sum(1 for s in spans if s[2].split("[")[0] == k) for k in sorted({
            s[2].split("[")[0] for s in spans})},
        job_s=[e - s for s, e, _ in jobs], result=res, gaps=gaps, device_ops=device_ops, reads=reads,
        idle_split=idle_split,
        device_span_names=sorted({name for _, _, name in tr.device if SPAN.match(name)}),
        gpu_annotations=sorted({e.name() for e in events if "CUDA" in str(e.device_type())
                                and e.is_user_annotation()})[:20],
    )
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    path = REPO / "chiprun_out" / f"spans_{args.tag}_{args.seed}.json"
    path.write_text(json.dumps(out, indent=1))
    brief = {k: out[k] for k in ("tag", "seed", "card", "torch", "span_us", "spans_a_job", "job_s", "reads",
                                 "idle_split", "device_span_names")}
    brief["metrics"] = {k: v["value"] for k, v in res["metrics"].items()}
    brief["correct"] = res["correct"]
    print(json.dumps(brief), flush=True)
    for g in gaps:
        print(f"gap {g['seconds']:.4f}s  {g['span']}  ({g['host_at']})", flush=True)
    for d in device_ops[:5]:
        print(f"op {d['seconds']:.4f}s {d['name'][:100]}: spans {d['spans']} torch {d['torch_ops']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
