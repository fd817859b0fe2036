"""Seconds from the process's start to the window's: imports, the kernels'
load (or build), the capture and the warm-up."""


def read(ctx):
    return ctx.setup_s
