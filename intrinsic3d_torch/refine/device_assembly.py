"""Device-resident per-iteration problem assembly (block-dense layout).

Counterpart of `intrinsic3d_tpu/refine/device_assembly.py` (dense layout):
normals, shell/ring/stencil gates, iso-projection, observation collection
with the per-voxel top-N, the creation-time validity probe
(``shading_cost.cpp:136-147``), the ×1000 per-type weight normalization
(``nls_solver.cpp:379-394``) and the free-parameter masks
(``optimizer.cpp:285-361``), all computed densely over block slots.
Per-level statics come from `build_level_static`, once per level. With
`bmap` the E_g elements are frame-bucketed (`blockform.BlockAssembly`): the
observations, the validity probe and the weights are evaluated only on each
frame's visible blocks. With `mesh` (the JAX function's `axis_name`) the
assembly runs on one rank's brick of a spatially sharded level
(`parallel/spmd.py`): its only cross-rank quantities, the weight sums of the
normalization and the pose-observability counts, are all-reduced.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from intrinsic3d_torch.camera import Camera
from intrinsic3d_torch.device import check_on, resolve_device
from intrinsic3d_torch.grid.blocks import BlockLayout, ShiftPlan, pad_flat
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid
from intrinsic3d_torch.mathutil import sdf_to_weight
from intrinsic3d_torch.observations import compute_observations_batch
from intrinsic3d_torch.refine.assembly import LevelTopology, chroma_weights
from intrinsic3d_torch.refine.blockform import BlockAssembly, _PLUS, _RING6, _eg_dense, _stencil_for
from intrinsic3d_torch.refine.residuals import Params
from intrinsic3d_torch.refine.solver import Masks


class LevelStatic(NamedTuple):
    """Per-(grid, pyramid)-level constants of the device assembly."""

    occ: torch.Tensor  # [nb+1, S] 1.0 where the slot holds a table voxel
    valid: torch.Tensor  # [nb+1, S] 1.0 where the fusion weight > 0
    vpos: torch.Tensor  # [3, nb·S] int32 voxel coords (0 on empty slots)
    es_ref: torch.Tensor  # [nb, S] fused sdf anchor
    eg_sh: torch.Tensor  # [9, nb·S] per-voxel SH coefficients
    ea_chroma: torch.Tensor  # [3, nb, S] static chromaticity pair weights


def build_level_static(
    layout: BlockLayout,
    grid: VoxelGrid,
    topo: LevelTopology,
    voxel_sh: np.ndarray,
    device="cuda",
) -> LevelStatic:
    """Host-side, once per level: scatter the static table fields to dense
    block slots and move them to `device`."""
    dev = resolve_device(device)
    s = layout.block**3
    nb = layout.num_blocks
    d = nb * s

    def densify(vals):
        out = np.zeros(d, np.float32)
        out[layout.vox_slot] = np.asarray(vals, np.float32)
        return out

    occ = np.zeros(d, np.float32)
    occ[layout.vox_slot] = 1.0
    valid = densify(grid.valid_mask().astype(np.float32))
    vpos = np.zeros((3, d), np.int32)
    vpos[:, layout.vox_slot] = topo.coords.astype(np.int32).T
    eg_sh = np.zeros((9, d), np.float32)
    eg_sh[:, layout.vox_slot] = np.asarray(voxel_sh, np.float32).T

    # albedo pair chromaticity, keyed at the lower-coordinate endpoint of each
    # +axis pair (``albedo_regularizer.cpp:60-72``)
    pairs = np.asarray(topo.ea_pairs)
    cw = chroma_weights(grid.color, pairs)
    delta = topo.coords[pairs[:, 1]].astype(np.int64) - topo.coords[pairs[:, 0]].astype(np.int64)
    slots_i = layout.vox_slot[pairs[:, 0]]
    slots_j = layout.vox_slot[pairs[:, 1]]
    ea_chroma = np.zeros((3, d), np.float32)
    for dd in range(3):
        e = np.zeros(3, np.int64)
        e[dd] = 1
        fwd = np.all(delta == e, axis=-1)
        bwd = np.all(delta == -e, axis=-1)
        ea_chroma[dd, slots_i[fwd]] = cw[fwd]
        ea_chroma[dd, slots_j[bwd]] = cw[bwd]

    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return LevelStatic(
        occ=pad_flat(t(occ.reshape(nb, s))),
        valid=pad_flat(t(valid.reshape(nb, s))),
        vpos=t(vpos),
        es_ref=t(densify(grid.sdf).reshape(nb, s)),
        eg_sh=t(eg_sh),
        ea_chroma=t(ea_chroma.reshape(3, nb, s)),
    )


def device_assembly(
    st: LevelStatic,
    sdf_plan: ShiftPlan,
    alb_plan: ShiftPlan,
    params: Params,  # block-dense Params ([nb+1, S] voxel fields)
    depths: torch.Tensor,  # [K, H, W]
    images: torch.Tensor,  # [K, H, W] intensity
    pyr_scale,
    voxel_size,
    truncation,
    thres_shell,
    occlusion_distance,
    lambdas: torch.Tensor,  # [4] raw (λ_g, λ_r, λ_s, λ_a) before normalization
    num_obs: int,
    width: int,
    height: int,
    fix_poses: bool = False,
    fix_intrinsics: bool = False,
    fix_distortion: bool = False,
    use_albedo: bool = True,
    bmap: Optional[torch.Tensor] = None,  # [K, NBc] int64 frame buckets (blockform), or None
    min_pose_obs: int = 0,
    device="cuda",
    mesh=None,
) -> Tuple[BlockAssembly, Masks]:
    """One relinearization assembly over the frame-major elements: dense
    `[K, nb, B³]`, or frame-bucketed `[K, NBc, B³]` with `bmap`. Every tensor
    argument must already lie on `device`. With `mesh` the statics, params,
    plans and buckets are one rank's (`parallel.spmd.SpmdLevel`)."""
    dev = resolve_device(device)
    check_on(
        dev, sdf=params.sdf, poses=params.poses, depths=depths, images=images, valid=st.valid,
        sdf_plan_nbr=sdf_plan.nbr, sdf_plan_lane_src=sdf_plan.lane_src,
        alb_plan_nbr=alb_plan.nbr, alb_plan_lane_src=alb_plan.lane_src,
    )
    if bmap is not None:
        check_on(dev, bmap=bmap)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    pyr_scale, voxel_size, truncation = f32(pyr_scale), f32(voxel_size), f32(truncation)
    thres_shell, occlusion_distance, lambdas = f32(thres_shell), f32(occlusion_distance), f32(lambdas)
    nb, s = st.es_ref.shape
    d = nb * s

    sh = sdf_plan.apply(params.sdf)  # [13, nb, S]
    vs = sdf_plan.apply(st.valid)
    oc = sdf_plan.apply(st.occ)
    c = sdf_plan.index((0, 0, 0))
    ex = sdf_plan.index((1, 0, 0))
    ey = sdf_plan.index((0, 1, 0))
    ez = sdf_plan.index((0, 0, 1))

    # --- normals + gates (``operators.cpp:58-77``, ``optimizer.cpp:185-199``)
    nb_valid = vs[c] * vs[ex] * vs[ey] * vs[ez]
    n = torch.stack([sh[ex] - sh[c], sh[ey] - sh[c], sh[ez] - sh[c]], dim=-1)
    norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    nonzero = norm[..., 0] > 0.0
    normal_ok = (nb_valid > 0.0) & nonzero
    normals = torch.where(
        normal_ok.unsqueeze(-1),
        n / torch.where(norm == 0.0, torch.ones_like(norm), norm),
        torch.zeros_like(n),
    )

    sdfr = sh[c]
    in_shell = (st.valid[:-1] > 0.0) & (torch.abs(sdfr) <= thres_shell)
    gate = in_shell & normal_ok
    stencil_ok = torch.all(oc[:10] > 0.0, dim=0)
    ring_ok = torch.ones((nb, s), dtype=torch.bool, device=dev)
    for off in _RING6:
        ring_ok = ring_ok & (vs[sdf_plan.index(off)] > 0.0)

    # --- observations with the current poses (``colorization.cpp:192-315``)
    cam = Camera(
        fx=params.intr[0] * pyr_scale,
        fy=params.intr[1] * pyr_scale,
        cx=params.intr[2] * pyr_scale,
        cy=params.intr[3] * pyr_scale,
        width=width,
        height=height,
        dist=params.dist,
    )
    pts = st.vpos.T.to(torch.float32) * voxel_size  # [D, 3]
    nflat = normals.reshape(d, 3)
    iso = pts - nflat * sdfr.reshape(d, 1)

    kframes = params.poses.shape[0]
    kcap = min(num_obs, kframes)
    eg_gate2 = gate & stencil_ok  # [nb, S]
    w_sdf2 = sdf_to_weight(sdfr, truncation)  # [nb, S]
    if bmap is None:
        eg_gate = eg_gate2.reshape(d)
        weights = compute_observations_batch(
            cam, params.poses, depths, iso, nflat, occlusion_distance,
            active=eg_gate.to(torch.float32).unsqueeze(0).expand(kframes, d),
        )  # [K, D]
        # frame-major top-N: keep each voxel's num_obs best frames in place
        # (row = keyframe). The double stable argsort is the per-voxel
        # descending rank with lax.top_k's tie order (the lower frame index
        # wins).
        order = torch.argsort(-weights, dim=0, stable=True)
        rank = torch.argsort(order, dim=0, stable=True)
        sel = rank < kcap
        eg_w = torch.where(
            eg_gate.unsqueeze(0) & sel, weights * w_sdf2.reshape(1, d), torch.zeros_like(weights)
        ).reshape(kframes, nb, s)
    else:
        # frame-bucketed elements: observations only on each frame's visible
        # blocks (block-row gathers; padding rows index the all-zero pad row,
        # so their gate, and hence their weight, is 0)
        nbc = bmap.shape[1]
        e = nbc * s
        rows_idx = bmap.reshape(-1)
        karr = torch.arange(kframes, device=dev).view(kframes, 1)

        def rows2(x):  # per-slot [nb, S] → bucketed [K, E]
            return pad_flat(x).index_select(0, rows_idx).view(kframes, e)

        def rows3(x):  # per-slot [D, C] → bucketed [K, E, C]
            x = x.reshape(nb, s, -1)
            return torch.cat([x, x.new_zeros(1, *x.shape[1:])]).index_select(0, rows_idx).view(kframes, e, -1)

        act_b = rows2(eg_gate2.to(torch.float32))
        weights_b = compute_observations_batch(
            cam, params.poses, depths, rows3(iso), rows3(nflat), occlusion_distance, active=act_b,
        )  # [K, E]
        # the top-N rank over all frames: one scatter back to per-slot
        # columns [K, nb+1, S] (the only K×D-sized transient of the bucketed
        # assembly), the dense branch's double stable argsort, and a gather
        # back to the buckets
        wfull = weights_b.new_zeros(kframes, nb + 1, s)
        wfull[karr, bmap] = weights_b.view(kframes, nbc, s)
        order = torch.argsort(-wfull.view(kframes, -1), dim=0, stable=True)
        rank = torch.argsort(order, dim=0, stable=True)
        sel_b = (rank < kcap).view(kframes, nb + 1, s)[karr, bmap].view(kframes, e)
        eg_w = torch.where(
            (act_b > 0.0) & sel_b, weights_b * rows2(w_sdf2), torch.zeros_like(weights_b)
        ).view(kframes, nbc, s)

    # --- E_r / E_s / E_a weights ----------------------------------------------
    one, zero = torch.ones((), device=dev), torch.zeros((), device=dev)
    er_w = torch.where(gate & ring_ok, one, zero) * torch.where(lambdas[1] > 0.0, one, zero)
    es_w = torch.where(gate, one, zero) * torch.where(lambdas[2] > 0.0, one, zero)
    av = torch.where(gate & ring_ok, one, zero)
    av_sh = sdf_plan.apply(pad_flat(av))
    ea_w = torch.stack(
        [st.ea_chroma[dd] * torch.maximum(av, av_sh[sdf_plan.index(e)]) for dd, e in enumerate(_PLUS)]
    ) * torch.where(lambdas[3] > 0.0, one, zero)

    # --- assembly with the creation-time validity probe -----------------------
    asm = BlockAssembly(
        eg_w=eg_w,
        eg_sh=st.eg_sh,
        eg_vpos=st.vpos,
        sdf_plan=sdf_plan,
        alb_plan=alb_plan,
        er_w=er_w,
        es_ref=st.es_ref,
        es_w=es_w,
        ea_w=ea_w,
        lam=torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
        images=images,
        pyr_scale=pyr_scale,
        voxel_size=voxel_size,
        bmap=bmap,
    )
    sha = alb_plan.apply(params.albedo)
    # validity-only probe: `r != 0` is a pure geometry predicate (see
    # eg_core), so the probe skips the image sampler
    probe_asm = asm._replace(eg_w=torch.ones_like(eg_w))
    valid_probe = _eg_dense(
        (params.poses, params.intr, params.dist),
        _stencil_for(probe_asm, sh, 10),
        _stencil_for(probe_asm, sha, 4),
        probe_asm,
        validity_only=True,
    )
    eg_w = torch.where(valid_probe != 0.0, eg_w, torch.zeros_like(eg_w))

    # per-type weight normalization ×1000 (``nls_solver.cpp:379-394``)
    def norm_lam(lmbda, wsum):
        ok = (wsum > 0.0) & (lmbda > 0.0)
        return torch.where(ok, lmbda / torch.where(ok, wsum, one) * 1000.0, zero)

    wsums = torch.stack([torch.sum(eg_w), torch.sum(er_w), torch.sum(es_w), torch.sum(ea_w)])
    if mesh is not None:
        # the weight sums are the assembly's only cross-rank quantities
        wsums = mesh.all_reduce(wsums)
    lam = torch.stack([norm_lam(lambdas[i], wsums[i]) for i in range(4)])
    asm = asm._replace(eg_w=eg_w, lam=lam)

    # --- free-parameter masks (``optimizer.cpp:285-361``) ---------------------
    free_pad = pad_flat(torch.where(in_shell & ring_ok, one, zero))
    pose_row = torch.full((kframes, 6), 0.0 if fix_poses else 1.0, device=dev)
    intr_row = torch.full((4,), 0.0 if fix_intrinsics else 1.0, device=dev)
    dist_row = torch.full((5,), 0.0 if fix_distortion else 1.0, device=dev)
    if min_pose_obs > 0 and not fix_poses:
        # Pose-observability gate (no reference equivalent): a keyframe whose
        # active E_g element count is below `min_pose_obs` has its pose frozen
        # this iteration — a starved pose block is rank-deficient and the
        # exact Schur global solve diverges along its null directions. The
        # intrinsics/distortion are frozen when the TOTAL count is too low.
        nobs = torch.sum((eg_w > 0.0).reshape(kframes, -1), dim=-1)
        if mesh is not None:
            nobs = mesh.all_reduce(nobs)
        pose_row = pose_row * (nobs >= min_pose_obs).to(torch.float32).unsqueeze(-1)
        total_ok = (torch.sum(nobs) >= min_pose_obs).to(torch.float32)
        intr_row = intr_row * total_ok
        dist_row = dist_row * total_ok
    masks = Masks(
        sdf=free_pad,
        albedo=free_pad if use_albedo else torch.zeros_like(free_pad),
        poses=pose_row,
        intr=intr_row,
        dist=dist_row,
    )
    return asm, masks
