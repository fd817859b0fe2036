"""Millions of depth pixels the level planners' depth culling scanned in a
job: the levels' `OptimizeStats.plan_depth_px` (each plan reads its level's
depth maps once a frame-bucket pass, on the level's prep thread or its
own) summed over the job, averaged over the jobs. None where the program
keeps no such count."""


def read(ctx):
    v = [[getattr(lv["stats"], "plan_depth_px", None) for lv in j.levels] for j in ctx.jobs if j.levels]
    v = [sum(x) for x in v if None not in x]
    return sum(v) / len(v) / 1e6 if v else None
