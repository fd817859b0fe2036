"""Seconds of every level's solve but the finest (the `solve[...]` phases of
the engine's `stats=` before the last, summed; traced runs), averaged over
the jobs."""


def read(ctx):
    v = [[s for k, s in j.stats.items() if k.startswith("solve[")] for j in ctx.jobs if j.stats]
    v = [sum(x[:-1]) for x in v if len(x) > 1]
    return sum(v) / len(v) if v else None
