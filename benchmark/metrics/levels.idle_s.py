"""Seconds a job's device is idle inside the harness's `refine` ranges and
outside every `solve[...]` range of the program: the idle time of the
refinement driver and its level stages, averaged over the jobs."""

from benchmark.trace import busy_seconds, idle_gaps, union


def read(ctx):
    if not ctx.device or not ctx.host or not ctx.jobs:
        return None
    solves = [r for r in ctx.host if r[2].startswith("solve[")]
    if not solves:
        return None
    idle = 0.0
    for lo, hi in union([r for r in ctx.host if r[2] == "refine"]):
        for s, e in idle_gaps(solves, lo, hi):
            idle += (e - s) - busy_seconds(ctx.device, s, e)
    return idle / len(ctx.jobs)
