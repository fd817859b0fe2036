"""Milliseconds of device time a job spends reprojecting its keyframes'
depth to the colour camera: the device operations the program queued
inside its `pyramids.reproject` ranges (opened where the colour camera's
image size differs from the depth camera's), averaged over the jobs. The
operations run after the host has left the range, so they are found by
their order on the device's one stream: the n that start first once the
range has opened, n being the launches, memsets and copies the host queued
inside it. None where the program opens no such range."""

QUEUEING = ("cudaLaunch", "cuLaunch", "cudaMemsetAsync", "cudaMemcpyAsync")


def read(ctx):
    if not ctx.device or not ctx.host or not ctx.jobs:
        return None
    ranges = [(s, e) for s, e, name in ctx.host if name == "pyramids.reproject"]
    if not ranges:
        return None
    ops = sorted(ctx.device)
    total = 0.0
    for s, e in ranges:
        n = sum(1 for hs, he, name in ctx.host if s <= hs and he <= e and name.startswith(QUEUEING))
        total += sum(oe - os for os, oe, _ in [op for op in ops if op[0] >= s][:n])
    return total * 1e3 / len(ctx.jobs)
