"""Micrometres between the refined surface and the scene's analytic sphere:
the median of |refined sdf - true sdf| over the shell voxels (valid, |refined
sdf| under one voxel) of every job of the window, pooled."""

import numpy as np

from benchmark.check import surface_errors


def read(ctx):
    errs = [surface_errors(j.refined, ctx.cell.config["scene"]) for j in ctx.jobs if j.refined is not None]
    errs = np.concatenate(errs) if errs else np.zeros(0)
    return float(np.median(errs)) * 1e6 if errs.size else None
