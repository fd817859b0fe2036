"""Whether a job's outputs are correct: each stage the job ran held against
the plain reference (`benchmark/reference/`), which works every stage out
again from the inputs the stage had. A stage the job did not run (no
keyframe ids, no fused grid, no levels, no refined grid, no exports) is
skipped, so a job kind that runs fewer stages is checked on those it runs.

The refinement is chaotic at rounding scale, so the reference does not run
it a second time from the start: it follows the program level by level
from the program's own state at each level's start, and checks separately
what that skips: each level's start (the fused grid, the initial recolour,
the 2x upsample and the thin-shell sparsify between levels), the level's
lighting, its first and last cost, its closing recolour, and the refined
surface's gain against the scene's own.

`job_readings` returns the numbers compared, each a gap that a correct
run keeps small; `control=True` puts the reference itself, computed in
bfloat16, in the program's place (the control that has to come out not
correct).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from benchmark.reference import energy, fusion, keyframes, mesh, svsh, transition
from benchmark.reference.common import quantile, rotate, table_from_blocks, thin_shell, varying_lambda

LOW = torch.bfloat16
REF = torch.float64

# every number compared; each must stay at or under its limit
NUMBERS = ("kf_score_gap", "kf_id_mismatch", "fusion_voxel_mismatch", "fusion_gap", "transition_voxel_mismatch",
           "transition_gap", "svsh_gap", "cost_start_gap", "cost_end_gap", "recolor_gap", "refine_gain")
MESH_NUMBERS = ("mesh_vertex_gap", "mesh_missing_share")


def pose_matrices(p6: torch.Tensor) -> torch.Tensor:
    """World-to-camera 4x4 matrices of angle-axis + translation rows."""
    k = p6.shape[0]
    eye = torch.eye(3, dtype=p6.dtype, device=p6.device)
    R = rotate(p6[:, None, :3].expand(k, 3, 3), eye[None].expand(k, 3, 3)).transpose(1, 2)
    T = torch.eye(4, dtype=p6.dtype, device=p6.device).repeat(k, 1, 1)
    T[:, :3, :3], T[:, :3, 3] = R, p6[:, 3:]
    return T


class Frames:
    """The capture as the reference reads it: frames cut to the sensor's
    depth range, and the keyframes' pyramids."""

    def __init__(self, sensor_frames: dict, cfg: dict, dev):
        self.dev = dev
        self.colors = torch.as_tensor(np.stack(sensor_frames["colors"]), device=dev)
        d = torch.as_tensor(np.stack(sensor_frames["depths"]), device=dev)
        lo, hi = float(cfg["sensor"]["min_depth"]), float(cfg["sensor"]["max_depth"])
        self.depths = torch.where((d < lo) | (d > hi), torch.zeros_like(d), d)
        self.poses = torch.as_tensor(np.stack(sensor_frames["poses"]), device=dev)
        self.cam = sensor_frames["cam"]
        self._pyr = {}
        self._kf = None

    def reference_keyframes(self, cfg: dict):
        """The reference's blur scores (float64) and keyframe ids."""
        if self._kf is None:
            scores = keyframes.blur_scores(self.colors, REF)
            self._kf = scores, keyframes.select(scores.tolist(), int(cfg["keyframes"]["window_size"]))
        return self._kf

    def keyframes(self, ids, levels: int, dtype):
        key = (tuple(ids), dtype)
        if key not in self._pyr:
            i = torch.as_tensor(ids, device=self.dev)
            self._pyr[key] = energy.pyramid(self.colors[i], self.depths[i], levels, dtype)
        return self._pyr[key]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def job_readings(job, frames: Frames, cfg: dict, exports: dict | None, control: bool = False,
                 detail: dict | None = None) -> dict:
    """The numbers compared for one job, one group for each stage the job
    ran (module docstring). `detail`, when a dict, receives each level's
    readings and costs."""
    out = {}
    if job.kf_ids is not None:
        out.update(keyframe_readings(job, frames, cfg, control))
    if job.fused is not None:
        out.update(fusion_readings(job, frames, cfg, control))
    if job.levels:
        out.update(level_readings(job, frames, cfg, control, detail))
    if job.refined is not None:
        # the refinement's gain against the scene's own surface: a level
        # loop that leaves its state unchanged reads exactly 1
        refined, unrefined = surface_errors(job.refined, cfg["scene"], both=True)
        out["refine_gain"] = float(np.median(refined) / max(np.median(unrefined), 1e-30)) if refined.size else 1.0
    if exports and job.levels:
        out.update(export_readings(job, frames, exports, control))
    return out


def keyframe_readings(job, frames: Frames, cfg: dict, control: bool) -> dict:
    dev = frames.dev
    ref_scores, ref_ids = frames.reference_keyframes(cfg)
    window = int(cfg["keyframes"]["window_size"])
    cand = keyframes.blur_scores(frames.colors, LOW).double() if control else torch.as_tensor(job.kf_scores, device=dev)
    cand_ids = keyframes.select(cand.tolist(), window) if control else list(job.kf_ids)
    return dict(kf_score_gap=float(torch.max(torch.abs(cand.double() - ref_scores)) / torch.max(torch.abs(ref_scores))),
                kf_id_mismatch=float(len(set(cand_ids) ^ set(ref_ids))))


def fusion_readings(job, frames: Frames, cfg: dict, control: bool) -> dict:
    fr = (frames.depths, frames.colors, frames.poses, frames.cam, cfg["fusion"], float(cfg["sensor"]["min_depth"]),
          float(cfg["sensor"]["max_depth"]))
    ref_fused = fusion.fuse(*fr, dtype=REF)
    if control:
        c, s, w, col = fusion.fuse(*fr, dtype=LOW)
        cand_fused = dict(coords=c, sdf=s, weight=w, color=col)
    else:
        cand_fused = job.fused
    return fusion.compare_fused(cand_fused, ref_fused, float(cfg["fusion"]["voxel_size"]))


def last_step_state(lv_rec: dict, dev):
    """The table-order state (sdf_refined, albedo, poses) the level's last
    outer step started from, read out of the block parameters the recorder
    kept by the reference's own reading of the block layout; None when the
    level ran no outer step."""
    kept = lv_rec.get("last_step")
    if kept is None:
        return None
    coords, p = lv_rec["start"]["coords"], kept["params"]
    return dict(sdf_refined=table_from_blocks(coords, kept["block_coords"], kept["block"], p.sdf.detach().to(dev)),
                albedo=table_from_blocks(coords, kept["block_coords"], kept["block"], p.albedo.detach().to(dev)),
                poses=p.poses.detach())


def level_readings(job, frames: Frames, cfg: dict, control: bool, detail: dict | None) -> dict:
    """Every level's start, lighting, first and last cost and closing
    recolour (module docstring)."""
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
    intr = torch.tensor([frames.cam["fx"], frames.cam["fy"], frames.cam["cx"], frames.cam["cy"]], dtype=REF,
                        device=dev)
    dist = torch.zeros(5, dtype=REF, device=dev)

    t_gaps, t_mis = [], []
    levels = job.levels
    first = levels[0]
    fz = job.fused
    if fz is not None:
        # the first level's start: to_sbr of the fused grid, the initial
        # recolour with the capture's poses, the coarsest level's sparsify
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
        port_start = first["start"] if not control else _as_port(*start_of_first(LOW))
        cmp = transition.compare_grids(port_start, ref_c, ref_f, float(fz["voxel"]))
        t_gaps.append(cmp["gap"])
        t_mis.append(cmp["voxel_mismatch"])
        p6 = first["start"]["poses"].to(dev, REF)
        t_gaps.append(float(torch.max(torch.abs(pose_matrices(p6) - poses_w2c))))

    svsh_g, c0_g, c1_g, rec_g = [], [], [], []
    for n, lv_rec in enumerate(levels):
        st, en = lv_rec["start"], lv_rec["end"]
        voxel = float(st["voxel"])
        gl, rg = int(lv_rec["grid_level"]), int(lv_rec["rgbd"])
        thres = thin_shell(r3, gl, voxel)
        pyr_scale = 1.0 / (2.0 ** rg)
        size, lreg = float(r3["subvolume_size_sh"]), float(r3["subvolume_sh_lamda_reg"])

        last = last_step_state(lv_rec, dev) or en

        def level(src, dtype):
            return energy.Level(st["coords"], voxel, st["sdf"], st["weight"], st["color"], src["sdf_refined"],
                                src["albedo"], dtype, dev)

        def evaluate(dtype, p_images):
            l0, l1, l9 = level(st, dtype), level(en, dtype), level(last, dtype)
            sh, cells, coeffs = svsh.voxel_sh(l0, thres, size, lreg, with_cells=True)
            img, dep = p_images[rg]
            img, dep = img.to(dtype), dep.to(dtype)
            i_d = st["intr"].to(dev, dtype)
            d_d = st["dist"].to(dev, dtype)
            p_end = en["poses"].to(dev, dtype)
            args = (i_d, d_d, sh, img, dep, thres, occ, nobs, pyr_scale)
            a0 = energy.assemble(l0, st["poses"].to(dev, dtype), *args)
            a9 = energy.assemble(l9, last["poses"].to(dev, dtype), *args, at=(l1.sdfr, l1.albedo, p_end))
            col = energy.recolor(l1, p_end, i_d, d_d, depths0.to(dtype), colors_u8, occ, nobs)
            if detail is not None and dtype == REF:
                detail.setdefault("levels", []).append(dict(
                    level=f"g{gl}p{rg}", voxels=int(l0.coords.shape[0]), start_terms=a0.tolist(),
                    last_terms=a9.tolist(), costs_before=list(lv_rec["stats"].costs_before),
                    costs_after=list(lv_rec["stats"].costs_after)))
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
        c0_g.append(_rel(c0, e0))
        c1_g.append(_rel(c1, e1))
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
                port_next = nxt["start"] if not control else _as_port(ref_c, ref_f)
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
                port_next = nxt["start"] if not control else _as_port(*boundary(LOW))
            cmp = transition.compare_grids(port_next, ref_c, ref_f, float(nxt["start"]["voxel"]))
            t_gaps.append(cmp["gap"])
            t_mis.append(cmp["voxel_mismatch"])
            t_gaps.append(float(torch.max(torch.abs(nxt["start"]["poses"].to(dev, REF) - en["poses"].to(dev, REF)))))

    out = dict(svsh_gap=max(svsh_g), cost_start_gap=max(c0_g), cost_end_gap=max(c1_g), recolor_gap=max(rec_g))
    if t_gaps:
        out.update(transition_voxel_mismatch=max(t_mis), transition_gap=max(t_gaps))
    return out


def export_readings(job, frames: Frames, exports: dict, control: bool) -> dict:
    """The finest level's exported mesh against the crossings of its grid."""
    dev = frames.dev
    levels = job.levels
    last = levels[-1]["end"]
    c = torch.as_tensor(last["coords"], device=dev)
    w = torch.as_tensor(last["weight"], device=dev)
    s = torch.as_tensor(last["sdf_refined"], device=dev)
    vox = float(last["voxel"])
    if control:
        _, verts = mesh.crossing_vertices(c, s, w, vox, LOW)[:2]
        verts = verts.double().cpu().numpy()
    else:
        gl, rg = levels[-1]["grid_level"], levels[-1]["rgbd"]
        prefix = os.path.join(job.export_dir, exports["output_mesh_prefix"])
        verts = mesh.read_ply_vertices(f"{prefix}_g{gl}_p{rg}.ply")
    return mesh.compare_mesh(verts, c, s, w, vox, REF)


def _as_port(coords, fields: dict) -> dict:
    d = {k: v for k, v in fields.items()}
    d["coords"] = coords
    return d


def judge(readings: dict, limits: dict) -> dict:
    """{name: (value, limit, ok)} for every reading that has a limit."""
    res = {}
    for k, v in readings.items():
        lim = limits[k]
        res[k] = (v, lim, bool(math.isfinite(v) and v <= lim))
    return res


def surface_errors(grid, scene: dict, both: bool = False):
    """|refined sdf − analytic sphere sdf| on the valid voxels with |refined
    sdf| under one voxel (metres); with `both`, also the unrefined sdf's
    errors on the same voxels."""
    pts = grid.coords.astype(np.float64) * np.float64(np.float32(grid.voxel_size))
    true = np.linalg.norm(pts - np.asarray(scene["center"]), axis=-1) - float(scene["radius"])
    shell = (grid.weight > 0) & (np.abs(grid.sdf_refined) < grid.voxel_size)
    err = np.abs(grid.sdf_refined[shell] - true[shell])
    return (err, np.abs(grid.sdf[shell] - true[shell])) if both else err
