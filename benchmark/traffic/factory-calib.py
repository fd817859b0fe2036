"""The refinement from a factory calibration: `orbit10kf.reconstruct`'s job
with the sensor handed the configuration's `factory_camera` (the capture's
pinhole with scaled focal lengths, a shifted principal point and the given
distortion) as its colour and depth camera, the camera of a registered
RGB-D pair. With `fix_intrinsics` and `fix_distortion` 0 each level refines
the 4 intrinsics and 5 distortion coefficients with the poses, writes them
back into the sensor, and the next level starts from them.

`run_job` runs the default job (`benchmark/jobs.py`) from the factory
camera, keeps each level's closing intrinsics and distortion beside its
closing poses, and keeps the refined camera as `job.camera`.

`readings` is `benchmark/check.py`'s check following the camera: every
stage reads the capture through the factory camera; each level's start,
last outer step and close are evaluated at their own intrinsics and
distortion (the last step's trial state through `reference/camera.py`),
and the closing recolour at the closing camera; `transition_gap` also holds
the camera each level starts from to the one the level before closed with,
and the first level's to the factory camera. `globals_unmoved` counts the
intrinsics and distortion coefficients that end the job exactly where the
first level started them: a port that silently holds the camera reads 9.
`camera_moved_px` is how far the job moved the camera over the object:
the mean distance, in full-resolution pixels, between the projections
through the first level's starting camera and through the refined one of
the rays that meet the capture's sphere in the keyframes' views. A camera
that runs away along its barely observed directions (the focal length
against the cameras' distance, the principal point against their rotation)
moves by tens to hundreds of pixels and takes every observation with it,
where the factory calibration's whole error is under 2 pixels.
"""

from __future__ import annotations

import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import check, jobs
from benchmark.reference import camera, energy, svsh, transition
from benchmark.reference.common import project, quantile, thin_shell, varying_lambda

REF, LOW = check.REF, check.LOW


def factory_camera(cfg: dict, cam: dict) -> dict:
    """The configuration's factory calibration of the capture's camera `cam`
    (`frames["cam"]`), float32-rounded as the port's `Camera.create` holds
    it: fx, fy, cx, cy, width, height and `dist` (5)."""
    f = cfg["factory_camera"]
    r = lambda v: float(np.float32(v))  # noqa: E731
    return dict(fx=r(cam["fx"] * f["fx_scale"]), fy=r(cam["fy"] * f["fy_scale"]), cx=r(cam["cx"] + f["cx_shift_px"]),
                cy=r(cam["cy"] + f["cy_shift_px"]), width=int(cam["width"]), height=int(cam["height"]),
                dist=[r(d) for d in f["dist"]])


def run_job(kind, cell, cap, dev, rec, traced: bool, scratch: str, index: int):
    """The default job on the factory camera (module docstring)."""
    from intrinsic3d_torch.camera import Camera

    c = factory_camera(cell.config, cap.frames["cam"])
    cam = Camera.create(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"], c["dist"])
    cap.sensor.depth_cam = cam
    keep_level = rec.on_level

    def on_level(info):
        keep_level(info)
        if rec.levels and "end" in rec.levels[-1]:
            rec.levels[-1]["end"].update(intr=info.params.intr, dist=info.params.dist)

    rec.on_level = on_level
    try:
        # `harness.begin_job` hands the sensor the camera of the capture's `init`
        factory = SimpleNamespace(sensor=cap.sensor, frames=cap.frames, init=(cap.init[0], cam))
        job = jobs.run_job(kind, cell, factory, dev, rec, traced, scratch, index)
    finally:
        del rec.on_level
    refined = cap.sensor.color_cam
    job.camera = None
    if job.levels:
        job.camera = (np.array([refined.fx, refined.fy, refined.cx, refined.cy], np.float32),
                      np.asarray(refined.dist, np.float32))
    return job


def readings(kind, job, frames, cell, control: bool = False, detail=None) -> dict:
    """Every stage the job ran, held against the plain reference through the
    factory camera and, from the first level on, the camera the port
    refined (module docstring)."""
    cfg = cell.config
    fr = copy.copy(frames)
    fr.cam = factory_camera(cfg, frames.cam)
    out = check.job_readings(dataclasses.replace(job, levels=[]), fr, cfg, None, control=control)
    if job.levels:
        out.update(level_readings(job, fr, cfg, control, detail))
        start = job.levels[0]["start"]
        intr0, dist0 = start["intr"].cpu().numpy(), start["dist"].cpu().numpy()
        out["globals_unmoved"] = float(np.sum(job.camera[0] == intr0) + np.sum(job.camera[1] == dist0))
        out["camera_moved_px"] = camera_moved_px(fr, fr.reference_keyframes(cfg)[1], cfg["scene"], (intr0, dist0),
                                                 job.camera)
    return out


def camera_moved_px(frames: check.Frames, ids, scene: dict, cam0, cam1) -> float:
    """The mean distance, in full-resolution pixels, between the
    projections through `cam0` and `cam1` (intrinsics [4], distortion [5]
    each) of the rays that meet the sphere of `scene` in the views of the
    keyframes `ids`: a 16 x 16 grid over each view's disc of the sphere."""
    dev = frames.dev
    w2c = torch.linalg.inv(frames.poses[torch.as_tensor(ids, device=dev)].to(REF))
    c = w2c[:, :3, :3] @ torch.tensor(scene["center"], dtype=REF, device=dev) + w2c[:, :3, 3]
    t = torch.linspace(-1.0, 1.0, 16, dtype=REF, device=dev)
    gx, gy = torch.meshgrid(t, t, indexing="xy")
    disc = gx * gx + gy * gy <= 1.0
    rho = float(scene["radius"]) / c[:, 2:]
    x = c[:, :1] / c[:, 2:] + rho * gx[disc]
    y = c[:, 1:2] / c[:, 2:] + rho * gy[disc]
    p = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    (u0, v0, _), (u1, v1, _) = (project(torch.as_tensor(i, dtype=REF, device=dev),
                                        torch.as_tensor(d, dtype=REF, device=dev), 0, 0, p) for i, d in (cam0, cam1))
    return float(torch.mean(torch.hypot(u1 - u0, v1 - v0)))


def level_readings(job, frames: check.Frames, cfg: dict, control: bool, detail) -> dict:
    """`check.level_readings` with each evaluation at the camera the port
    held there: a level's start at its starting intrinsics and distortion,
    its last outer step linearized at the camera of the block parameters it
    started from and evaluated at the closing camera, its closing recolour
    at the closing camera."""
    dev = frames.dev
    r3 = cfg["intrinsic3d"]
    nobs, occ = int(r3["num_observations"]), float(r3["occlusion_distance"])
    iters, levels_rgbd = int(r3["iterations"]), int(r3["num_rgbd_levels"])
    lam_first = (float(r3["lambda_g"]), float(r3["lambda_r0"]), float(r3["lambda_s0"]), float(r3["lambda_a"]))
    lam_last = (float(r3["lambda_g"]), varying_lambda(iters - 1, iters, float(r3["lambda_r0"]), float(r3["lambda_r1"])),
                varying_lambda(iters - 1, iters, float(r3["lambda_s0"]), float(r3["lambda_s1"])), float(r3["lambda_a"]))

    _, ref_ids = frames.reference_keyframes(cfg)
    pyr = frames.keyframes(ref_ids, levels_rgbd, REF)
    pyr_low = frames.keyframes(ref_ids, levels_rgbd, LOW) if control else None
    kf = torch.as_tensor(ref_ids, device=dev)
    colors_u8 = torch.clamp(frames.colors[kf] * 255.0, 0, 255).to(torch.uint8)
    depths0 = pyr[0][1]
    cam = frames.cam
    intr = torch.tensor([cam["fx"], cam["fy"], cam["cx"], cam["cy"]], dtype=REF, device=dev)
    dist = torch.tensor(cam["dist"], dtype=REF, device=dev)

    def camera_gap(a, b):
        """Largest gap of two (intrinsics, distortion) pairs."""
        return max(float(torch.max(torch.abs(x.to(dev, REF) - y.to(dev, REF)))) for x, y in zip(a, b))

    t_gaps, t_mis = [], []
    levels = job.levels
    first = levels[0]
    fz = job.fused
    if fz is not None:
        # the first level's start: to_sbr of the fused grid, the initial
        # recolour with the capture's poses and the factory camera, the
        # coarsest level's sparsify
        poses_w2c = torch.linalg.inv(frames.poses[kf].double())
        keep = np.asarray(fz["weight"]) > 0
        base = {k: torch.as_tensor(np.asarray(fz[k])[keep], device=dev) for k in ("coords", "sdf", "weight", "color")}
        thres0 = thin_shell(r3, int(first["grid_level"]), float(fz["voxel"]))

        def start_of_first(dtype):
            lv = energy.Level(base["coords"], fz["voxel"], base["sdf"], base["weight"], base["color"], base["sdf"],
                              torch.full_like(base["sdf"], 0.6), dtype, dev)
            p6 = first["start"]["poses"].to(dev, dtype)
            col = energy.recolor(lv, p6, intr.to(dtype), dist.to(dtype), depths0.to(dtype), colors_u8, occ, nobs)
            keep_s = transition.sparsify(lv.coords, lv.sdfr, base["weight"], thres0)
            f = dict(sdf=lv.sdf, weight=base["weight"].to(dtype), color=col, albedo=lv.albedo, sdf_refined=lv.sdfr)
            return lv.coords[keep_s], {k: v[keep_s] for k, v in f.items()}

        ref_c, ref_f = start_of_first(REF)
        port_start = first["start"] if not control else check._as_port(*start_of_first(LOW))
        cmp = transition.compare_grids(port_start, ref_c, ref_f, float(fz["voxel"]))
        t_gaps.append(cmp["gap"])
        t_mis.append(cmp["voxel_mismatch"])
        p6 = first["start"]["poses"].to(dev, REF)
        t_gaps.append(float(torch.max(torch.abs(check.pose_matrices(p6) - poses_w2c))))
    t_gaps.append(camera_gap((first["start"]["intr"], first["start"]["dist"]), (intr, dist)))

    svsh_g, c0_g, c1_g, rec_g = [], [], [], []
    for n, lv_rec in enumerate(levels):
        st, en = lv_rec["start"], lv_rec["end"]
        voxel = float(st["voxel"])
        gl, rg = int(lv_rec["grid_level"]), int(lv_rec["rgbd"])
        thres = thin_shell(r3, gl, voxel)
        pyr_scale = 1.0 / (2.0 ** rg)
        size, lreg = float(r3["subvolume_size_sh"]), float(r3["subvolume_sh_lamda_reg"])

        last = check.last_step_state(lv_rec, dev) or en
        kept = lv_rec.get("last_step")
        cam_last = (kept["params"].intr, kept["params"].dist) if kept is not None else (en["intr"], en["dist"])

        def level(src, dtype):
            return energy.Level(st["coords"], voxel, st["sdf"], st["weight"], st["color"], src["sdf_refined"],
                                src["albedo"], dtype, dev)

        def evaluate(dtype, p_images):
            l0, l1, l9 = level(st, dtype), level(en, dtype), level(last, dtype)
            sh, cells, coeffs = svsh.voxel_sh(l0, thres, size, lreg, with_cells=True)
            img, dep = p_images[rg]
            img, dep = img.to(dtype), dep.to(dtype)
            i0, d0 = (t.detach().to(dev, dtype) for t in (st["intr"], st["dist"]))
            i9, d9 = (t.detach().to(dev, dtype) for t in cam_last)
            i1, d1 = (t.detach().to(dev, dtype) for t in (en["intr"], en["dist"]))
            p_end = en["poses"].to(dev, dtype)
            rest = (img, dep, thres, occ, nobs, pyr_scale)
            a0 = energy.assemble(l0, st["poses"].to(dev, dtype), i0, d0, sh, *rest)
            a9 = camera.assemble(l9, last["poses"].to(dev, dtype), i9, d9, sh, *rest,
                                 at=(l1.sdfr, l1.albedo, p_end, i1, d1))
            col = energy.recolor(l1, p_end, i1, d1, depths0.to(dtype), colors_u8, occ, nobs)
            if detail is not None and dtype == REF:
                detail.setdefault("levels", []).append(dict(
                    level=f"g{gl}p{rg}", voxels=int(l0.coords.shape[0]), start_terms=a0.tolist(),
                    last_terms=a9.tolist(), costs_before=list(lv_rec["stats"].costs_before),
                    costs_after=list(lv_rec["stats"].costs_after), tries=list(lv_rec["stats"].tries),
                    intr_end=i1.tolist(), dist_end=d1.tolist()))
            return (cells, coeffs), (energy.cost(a0, lam_first), energy.cost(a9, lam_last)), col

        (ref_cells, ref_coeffs), (e0, e1), col_ref = evaluate(REF, pyr)
        if control:
            (cells_c, coeffs_c), (c0, c1), col_c = evaluate(LOW, pyr_low)
        else:
            light = lv_rec["lighting"]
            cells_c, coeffs_c = light.subvolumes.indices, light.coeffs
            c0, c1 = lv_rec["stats"].costs_before[0], lv_rec["stats"].costs_after[-1]
            col_c = torch.as_tensor(en["color"], device=dev)
        svsh_g.append(svsh.compare_coefficients(cells_c, coeffs_c, ref_cells, ref_coeffs))
        c0_g.append(check._rel(c0, e0))
        c1_g.append(check._rel(c1, e1))
        rec_g.append(quantile(torch.abs(col_c.double() - col_ref).max(-1).values, 0.99))
        if detail is not None and not control:
            detail["levels"][-1].update(svsh_gap=svsh_g[-1], cost_start_gap=c0_g[-1], cost_end_gap=c1_g[-1],
                                        recolor_gap=rec_g[-1], e0=e0, e1=e1, c0=c0, c1=c1)

        if n + 1 < len(levels):
            nxt = levels[n + 1]
            if int(nxt["grid_level"]) == gl:
                # the next pyramid level of the same grid starts where this one ended
                ref_c = torch.as_tensor(en["coords"], device=dev).to(torch.int64)
                ref_f = {k: torch.as_tensor(en[k], device=dev) for k in ("sdf", "weight", "color", "albedo",
                                                                         "sdf_refined")}
                port_next = nxt["start"] if not control else check._as_port(ref_c, ref_f)
            else:
                thres_n = thin_shell(r3, int(nxt["grid_level"]), voxel * 0.5)

                def boundary(dtype):
                    f = {k: torch.as_tensor(en[k], device=dev).to(dtype) for k in ("sdf", "color", "albedo",
                                                                                   "sdf_refined")}
                    f["weight"] = torch.as_tensor(en["weight"], device=dev)
                    cc, ff = transition.upsample(torch.as_tensor(en["coords"], device=dev), f, dtype)
                    k_ = transition.sparsify(cc, ff["sdf_refined"], ff["weight"], thres_n)
                    return cc[k_], {k: v[k_] for k, v in ff.items()}

                ref_c, ref_f = boundary(REF)
                port_next = nxt["start"] if not control else check._as_port(*boundary(LOW))
            cmp = transition.compare_grids(port_next, ref_c, ref_f, float(nxt["start"]["voxel"]))
            t_gaps.append(cmp["gap"])
            t_mis.append(cmp["voxel_mismatch"])
            t_gaps.append(float(torch.max(torch.abs(nxt["start"]["poses"].to(dev, REF) - en["poses"].to(dev, REF)))))
            t_gaps.append(camera_gap((nxt["start"]["intr"], nxt["start"]["dist"]), (en["intr"], en["dist"])))

    out = dict(svsh_gap=max(svsh_g), cost_start_gap=max(c0_g), cost_end_gap=max(c1_g), recolor_gap=max(rec_g),
               transition_gap=max(t_gaps))
    if t_mis:
        out["transition_voxel_mismatch"] = max(t_mis)
    return out
