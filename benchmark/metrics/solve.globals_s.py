"""Seconds of a job's level solves spent on the Schur branch's global block
(its Gram matrix, each LM try's damped factorization and the
back-substitution): the union of the program's `solve.globals` ranges (host
clock, traced runs), averaged over the jobs. None where the program opens
no such range."""

from benchmark.trace import union


def read(ctx):
    if not ctx.host or not ctx.jobs:
        return None
    spans = union([r for r in ctx.host if r[2] == "solve.globals"])
    return sum(e - s for s, e in spans) / len(ctx.jobs) if spans else None
