"""Kernels launched a job: the profiler's device kernels (copies and sets
left out) over the jobs of the traced window."""


def read(ctx):
    if not ctx.device or not ctx.jobs:
        return None
    n = sum(1 for _, _, name in ctx.device if not name.startswith(("Memcpy", "Memset")))
    return n / len(ctx.jobs) if n else None
