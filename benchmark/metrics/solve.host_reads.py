"""Device-to-host reads of a job's level solves: the levels'
`OptimizeStats.host_reads` (the program's count of the reads between a
level's first and last outer step, each of which waits for the queued
kernels) summed over the job, averaged over the jobs. None where the
program keeps no such count."""


def read(ctx):
    v = [[getattr(lv["stats"], "host_reads", None) for lv in j.levels] for j in ctx.jobs if j.levels]
    v = [sum(x) for x in v if None not in x]
    return sum(v) / len(v) if v else None
