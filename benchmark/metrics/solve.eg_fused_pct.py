"""Per cent of a job's E_g passes that ran through the E_g kernel: the
levels' `OptimizeStats.eg_fused` over `eg_fused + eg_eager` (one pass a
frame chunk of a linearization or an acceptance cost), summed over the
job's levels, then over the jobs. 100 on the card; lower where a chunk fell
back to the eager pass. None where the program keeps no such count."""


def read(ctx):
    fused = eager = 0
    for job in ctx.jobs:
        for lv in job.levels:
            f = getattr(lv["stats"], "eg_fused", None)
            e = getattr(lv["stats"], "eg_eager", None)
            if f is None or e is None:
                return None
            fused, eager = fused + f, eager + e
    return 100.0 * fused / (fused + eager) if fused + eager > 0 else None
