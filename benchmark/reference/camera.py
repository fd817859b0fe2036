"""The joint refinement's energy at a trial state that moves the camera too:
the LM try of a level whose intrinsics and distortion are free
(optimizer.cpp:285-361 with `fix_intrinsics`, `fix_distortion` 0).

`energy.assemble` evaluates a trial state of the surface and the poses
through the linearization's camera; here the trial state also carries its
own full-resolution intrinsics and distortion. As there, the gates, the
observations and their weights stay those of the linearization point (its
state, poses and camera), an element invalid there is dropped, and an
element that evaluates invalid at the trial state adds 0. Only E_g sees the
camera: E_r, E_s and E_a are `energy.assemble`'s. Plain PyTorch in any
dtype; nothing here imports the program under test.
"""

from __future__ import annotations

import torch

from benchmark.reference import energy
from benchmark.reference.common import surface_normals


def assemble(lv: energy.Level, poses, intr, dist, sh, images, depths, thres, occlusion, num_obs, pyr_scale, at):
    """`energy.assemble`'s `[4, 2]` (Σ w·r², Σ w) of (E_g, E_r, E_s, E_a) for
    the problem linearized at the state of `lv` with `poses`, `intr` and
    `dist`, with the residuals at `at` = (sdf_refined, albedo, poses, intr,
    dist), the trial state and its camera."""
    se, ae, pe, _, _ = at
    out = energy.assemble(lv, poses, intr, dist, sh, images, depths, thres, occlusion, num_obs, pyr_scale,
                          at=(se, ae, pe))
    out[0] = eg_term(lv, poses, intr, dist, sh, images, depths, thres, occlusion, num_obs, pyr_scale, at)
    return out


def eg_term(lv: energy.Level, poses, intr, dist, sh, images, depths, thres, occlusion, num_obs, pyr_scale, at):
    """E_g's (Σ w·r², Σ w) at the trial state `at` (`assemble`), its
    elements and weights from the linearization point."""
    dt = lv.dtype
    s, a = lv.sdfr, lv.albedo
    se, ae, pe, intr_t, dist_t = at
    n = s.shape[0]
    trunc = 5.0 * lv.voxel
    normals, nok = surface_normals(s, lv.nbr4, lv.valid)
    gate = lv.valid & (torch.abs(s) <= thres) & nok
    stencil_ok = torch.all(lv.eg10 >= 0, dim=-1)
    w_sdf = torch.clamp(1.0 - torch.clamp(torch.abs(s), max=trunc) / trunc, 0.01, 1.0)
    intr_l, intr_tl = intr.to(dt) * pyr_scale, intr_t.to(dt) * pyr_scale
    iso = lv.coords.to(dt) * lv.voxel - normals * s[:, None]
    out = torch.zeros(2, dtype=torch.float64, device=s.device)
    for beg in range(0, n, energy._CHUNK):
        sl = slice(beg, min(beg + energy._CHUNK, n))
        ow, of = energy.best_observations(poses, intr_l, dist, depths, iso[sl], normals[sl], occlusion, num_obs)
        ew = torch.where((gate[sl] & stencil_ok[sl])[:, None], ow * w_sdf[sl, None], torch.zeros_like(ow))
        vi, bi = torch.nonzero(ew > 0, as_tuple=True)
        vox, fr = vi + beg, of[vi, bi]
        st10, st4 = lv.eg10[vox], lv.nbr4[vox].clamp(min=0)
        r = energy.eg_residual(s[st10], a[st4], poses[fr], intr_l, dist, sh[vox], lv.coords[vox], fr, images,
                               lv.voxel)
        wr = ew[vi, bi] * (r != 0)
        r = energy.eg_residual(se[st10], ae[st4], pe[fr], intr_tl, dist_t, sh[vox], lv.coords[vox], fr, images,
                               lv.voxel)
        out[0] += torch.sum(wr.double() * r.double() ** 2)
        out[1] += torch.sum(wr.double())
    return out
