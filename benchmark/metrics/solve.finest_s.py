"""Seconds of the finest level's solve (the last `solve[...]` phase of the
engine's `stats=`, traced runs), averaged over the jobs."""


def read(ctx):
    v = [[s for k, s in j.stats.items() if k.startswith("solve[")] for j in ctx.jobs if j.stats]
    v = [x[-1] for x in v if x]
    return sum(v) / len(v) if v else None
