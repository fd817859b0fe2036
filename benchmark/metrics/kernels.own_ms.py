"""Milliseconds of device time a job spends in the port's own kernels (the
element stream of K1a, K1b and K2, the bicubic backward, the fused
distance-transform sweeps), by kernel name in the profiler's trace."""

OWN = ("rows_vec_kernel", "bicubic_rows_kernel", "fused_sweeps_kernel")


def read(ctx):
    if not ctx.device or not ctx.jobs:
        return None
    own = sum(e - s for s, e, name in ctx.device if any(k in name for k in OWN))
    return own * 1e3 / len(ctx.jobs) if own > 0 else None
