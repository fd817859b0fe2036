"""Levenberg-Marquardt tries of a job's level solves: the levels'
`OptimizeStats.tries` (one count an outer step; a rejected try costs a
solve, a candidate cost and a host read) summed over the job, averaged over
the jobs. None where the program keeps no such count."""


def read(ctx):
    v = [[getattr(lv["stats"], "tries", None) for lv in j.levels] for j in ctx.jobs if j.levels]
    v = [sum(sum(t) for t in x) for x in v if None not in x]
    return sum(v) / len(v) if v else None
