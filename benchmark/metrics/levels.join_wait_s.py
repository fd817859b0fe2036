"""Seconds a job's main thread waits at the joins of the host preparation
threads: the union of the program's `join[...]` ranges, averaged over the
jobs."""

from benchmark.trace import union


def read(ctx):
    if not ctx.host or not ctx.jobs:
        return None
    joins = union([r for r in ctx.host if r[2].startswith("join[")])
    return sum(e - s for s, e in joins) / len(ctx.jobs) if joins else None
