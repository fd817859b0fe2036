"""Seconds a job's refinement spends outside the level solves on its main
thread: the engine's phases (`stats=`, traced runs) summed, leaving out
`solve[...]` and the background threads' own `prefetch[...]` and
`upsample_prep[...]`, which overlap the others. Averaged over the jobs."""

SKIP = ("solve[", "prefetch[", "upsample_prep[")


def read(ctx):
    v = [sum(s for k, s in j.stats.items() if isinstance(s, float) and not k.startswith(SKIP))
         for j in ctx.jobs if j.stats]
    return sum(v) / len(v) if v else None
