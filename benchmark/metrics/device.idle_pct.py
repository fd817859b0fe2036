"""Per cent of the traced jobs' wall clock that no device operation covers
(the union of the profiler's device intervals, from the first job's start to
the last job's end)."""

from benchmark.trace import busy_seconds


def read(ctx):
    if not ctx.device or ctx.traced is None:
        return None
    lo, hi = ctx.traced
    return 100.0 * (1.0 - busy_seconds(ctx.device, lo, hi) / (hi - lo))
