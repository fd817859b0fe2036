"""Per cent of the level solves' time in which the device is idle: the share
of the union of the program's `solve[...]` ranges that no device interval
covers."""

from benchmark.trace import busy_seconds, union


def read(ctx):
    if not ctx.device or not ctx.host:
        return None
    solves = union([r for r in ctx.host if r[2].startswith("solve[")])
    total = sum(e - s for s, e in solves)
    if total <= 0.0:
        return None
    busy = sum(busy_seconds(ctx.device, s, e) for s, e in solves)
    return 100.0 * (1.0 - busy / total)
