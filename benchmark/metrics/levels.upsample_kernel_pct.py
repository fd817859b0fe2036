"""Per cent of the program's `upsample.fields` ranges inside the jobs'
`refine` ranges (one a grid-level boundary) during which the device ran the
upsample kernel (`upsample_fields_kernel` in the profiler's trace): 100
where every boundary resampled its fields on the card, 0 where the host
did. None where no such range or no device operation was traced."""

from benchmark.trace import union

KERNEL = "upsample_fields_kernel"


def read(ctx):
    if not ctx.device or not ctx.host or not ctx.jobs:
        return None
    refine = union([r for r in ctx.host if r[2] == "refine"])
    ranges = [(s, e) for s, e, name in ctx.host
              if name == "upsample.fields" and any(lo <= s and e <= hi for lo, hi in refine)]
    if not ranges:
        return None
    kernels = [(s, e) for s, e, name in ctx.device if KERNEL in name]
    held = sum(any(ks < e and s < ke for ks, ke in kernels) for s, e in ranges)
    return 100.0 * held / len(ranges)
