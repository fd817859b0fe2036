"""Peak device memory of a job in GB (1e9 bytes): the largest of the level
solves' own peaks (each level resets the peak counter at its start) and the
allocator's peak at the job's end; the largest over the jobs."""


def read(ctx):
    return max(j.peak_bytes for j in ctx.jobs) / 1e9 if ctx.jobs and ctx.peak_bytes else None
