"""Seconds a capture takes: the window's whole time over the jobs it ran."""


def read(ctx):
    return ctx.window_s / len(ctx.jobs) if ctx.jobs else None
