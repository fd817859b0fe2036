"""Sharded non-solver stages of a level: SVSH lighting and the recolor sweep.

Counterpart of `intrinsic3d_tpu/parallel/spmd_stages.py`; each `shard_map`
body becomes code a rank runs on its own brick:

- **SVSH estimate** (``lighting_svsh.cpp:166-346``): each rank forms the
  unnormalized normal equations `A_u`, `b_u` and the weight sum over its
  brick's voxels (normals through the same halo'd shift plan the solver
  uses; `lighting.svsh.normal_equation_parts`), all-reduces them with the
  count of contributing voxels, scales by 1/Σw, and runs the replicated
  block-Jacobi PCG (`lighting.svsh.solve_block_system`); rank 0's solution
  is broadcast so every rank holds the same coefficients bit for bit.
- **Per-voxel SH**: each rank interpolates the `[S, 9]` coefficients at its
  brick's voxels (`trilerp_subvolumes`); the `[9, m, B³]` result feeds
  `SpmdLevel` directly, so the full-grid field never exists on one rank.
- **Recolor sweep** (``colorization.cpp:162-212``): normals → iso points →
  all-frame observation weights through the depth-probe kernel → per-voxel
  top-N → weighted bilinear recolor, on the brick's voxels with the images
  replicated; the colors stay on the rank and feed the next SVSH estimate.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from intrinsic3d_torch.camera import Camera
from intrinsic3d_torch.color import intensity
from intrinsic3d_torch.grid.blocks import BlockLayout, pad_flat
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid
from intrinsic3d_torch.lighting.sh import sh_basis
from intrinsic3d_torch.lighting.subvolumes import Subvolumes
from intrinsic3d_torch.lighting.svsh import (
    SVSHResult,
    normal_equation_parts,
    solve_block_system,
    trilerp_subvolumes,
)
from intrinsic3d_torch.mathutil import sdf_to_weight
from intrinsic3d_torch.observations import compute_observations_batch
from intrinsic3d_torch.parallel.sharding import Mesh
from intrinsic3d_torch.parallel.spmd import SpmdContext
from intrinsic3d_torch.parallel.staging import stage_replicated, stage_rows, stage_table_rows, to_global
from intrinsic3d_torch.refine.residuals import Params


def place_block_params(mesh: Mesh, layout: BlockLayout, params: Params) -> Params:
    """Table params → this rank's block rows `[m+1, B³]` (with the pad row),
    built on the host from the table and placed on the rank's device; the
    globals replicated."""

    def brick(t):
        return pad_flat(stage_table_rows(mesh, layout, t.detach().cpu().numpy()))

    return Params(
        sdf=brick(params.sdf),
        albedo=brick(params.albedo),
        poses=params.poses.to(mesh.device),
        intr=params.intr.to(mesh.device),
        dist=params.dist.to(mesh.device),
    )


def shard_fraction(local: torch.Tensor, global_shape) -> float:
    """This rank's bytes of a field over the field's global bytes: 1/n for
    an evenly brick-sharded field, 1.0 for a replicated one."""
    return local.numel() / max(int(np.prod(global_shape)), 1)


def _block_normals(sdf_plan, sdf_pad, valid_pad):
    """Forward-difference surface normals on the rank's block rows — the
    halo'd twin of `grid.ops.surface_normals` (``operators.cpp:58-77``), the
    gating `refine.device_assembly` uses."""
    sh = sdf_plan.apply(sdf_pad)  # [13, m, S]
    vs = sdf_plan.apply(valid_pad)
    c = sdf_plan.index((0, 0, 0))
    ex = sdf_plan.index((1, 0, 0))
    ey = sdf_plan.index((0, 1, 0))
    ez = sdf_plan.index((0, 0, 1))
    nb_valid = vs[c] * vs[ex] * vs[ey] * vs[ez]
    n = torch.stack([sh[ex] - sh[c], sh[ey] - sh[c], sh[ez] - sh[c]], dim=-1)
    norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    ok = (nb_valid > 0.0) & (norm[..., 0] > 0.0)
    normals = torch.where(ok.unsqueeze(-1), n / torch.where(norm == 0.0, torch.ones_like(norm), norm),
                          torch.zeros_like(n))
    return sh[c], normals, ok


def _bilinear_frame_rows(images: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of `images [K, H, W, C]` at `(u, v) [K, D]` where row
    k samples frame k (out-of-image taps weigh 0, the rest renormalized; no
    valid tap gives 0), as `observations.bilinear_frames` does."""
    k, h, w = images.shape[0], images.shape[1], images.shape[2]
    x0 = torch.floor(u).to(torch.int64)
    y0 = torch.floor(v).to(torch.int64)
    x1, y1 = x0 + 1, y0 + 1
    wx1 = u - x0.to(u.dtype)
    wy1 = v - y0.to(v.dtype)
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    zero = torch.zeros_like(wx0)
    wx0 = torch.where((x0 >= 0) & (x0 < w), wx0, zero)
    wx1 = torch.where((x1 >= 0) & (x1 < w), wx1, zero)
    wy0 = torch.where((y0 >= 0) & (y0 < h), wy0, zero)
    wy1 = torch.where((y1 >= 0) & (y1 < h), wy1, zero)
    x0c, x1c = torch.clamp(x0, 0, w - 1), torch.clamp(x1, 0, w - 1)
    y0c, y1c = torch.clamp(y0, 0, h - 1), torch.clamp(y1, 0, h - 1)
    flat = images.reshape(k, h * w, -1).to(torch.float32)

    def tap(yc, xc):
        idx = (yc * w + xc).unsqueeze(-1).expand(-1, -1, flat.shape[-1])
        return torch.gather(flat, 1, idx)

    w00, w10, w01, w11 = wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1
    acc = (
        tap(y0c, x0c) * w00.unsqueeze(-1)
        + tap(y0c, x1c) * w10.unsqueeze(-1)
        + tap(y1c, x0c) * w01.unsqueeze(-1)
        + tap(y1c, x1c) * w11.unsqueeze(-1)
    )
    wsum = w00 + w10 + w01 + w11
    wsafe = torch.where(wsum > 0.0, wsum, torch.ones_like(wsum))
    return torch.where(wsum.unsqueeze(-1) > 0.0, acc / wsafe.unsqueeze(-1), torch.zeros_like(acc))


@dataclasses.dataclass
class SpmdStages:
    """One grid level's sharded SVSH and recolor stages on this rank.

    Built once per (grid level, mesh): the level's static per-voxel fields
    as the rank's block rows, the subvolume partition (found on the host,
    as the single-device `estimate_svsh` does) and the replicated images.
    Per-voxel inputs and outputs stay on the rank; only the `[S, 9]`
    coefficients and the counts are replicated."""

    mesh: Mesh
    ctx: SpmdContext
    layout: BlockLayout
    subvolumes: Subvolumes
    num_best: int
    occlusion_distance: float
    truncation: float
    width: int
    height: int
    voxel_size: float
    valid: torch.Tensor  # [m, S] 1.0 where the fusion weight > 0
    vpos: torch.Tensor  # [3, m, S] int32 voxel coords (0 on empty slots)
    subvol: torch.Tensor  # [m, S] int64 subvolume id, −1 outside the partition or empty
    occ: torch.Tensor  # [m, S] 1.0 where the slot holds a table voxel
    cell_tab: torch.Tensor
    cell_origin: torch.Tensor
    pairs: torch.Tensor
    depths0: torch.Tensor  # [K, H, W] full-resolution depth maps
    colors0: torch.Tensor  # [K, H, W, 3] uint8 source colors

    @classmethod
    def build(
        cls,
        mesh: Mesh,
        ctx: SpmdContext,
        layout: BlockLayout,
        grid: VoxelGrid,
        cam: Camera,
        depths0: torch.Tensor,
        colors0: torch.Tensor,
        subvolume_size: float,
        num_best: int,
        occlusion_distance: float,
    ) -> Optional["SpmdStages"]:
        pts = grid.voxel_to_world()
        sub = Subvolumes.compute(pts, subvolume_size)
        if grid.num_voxels == 0 or sub.count == 0:
            return None
        nb, s = layout.num_blocks, layout.block**3
        coords = grid.coords.astype(np.int32)
        slot = layout.vox_slot

        def vpos_rows(lo, hi):
            out = np.zeros((3, (hi - lo) * s), np.int32)
            sel = (slot >= lo * s) & (slot < hi * s)
            out[:, slot[sel] - lo * s] = coords[sel].T
            return out.reshape(3, hi - lo, s)

        tab, origin = sub.cell_lookup()
        return cls(
            mesh=mesh,
            ctx=ctx,
            layout=layout,
            subvolumes=sub,
            num_best=int(num_best),
            occlusion_distance=float(occlusion_distance),
            truncation=float(grid.truncation),
            width=int(cam.width),
            height=int(cam.height),
            voxel_size=float(grid.voxel_size),
            valid=stage_table_rows(mesh, layout, grid.valid_mask().astype(np.float32)),
            vpos=stage_rows(mesh, (3, nb, s), np.int32, vpos_rows, 1),
            subvol=stage_table_rows(mesh, layout, sub.point_to_subvolume(pts), dtype=np.int64, fill=-1),
            occ=stage_table_rows(mesh, layout, np.ones(grid.num_voxels, np.float32)),
            cell_tab=stage_replicated(mesh, np.asarray(tab, np.int64)),
            cell_origin=stage_replicated(mesh, np.asarray(origin, np.int64)),
            pairs=stage_replicated(mesh, np.asarray(sub.neighbor_pairs(), np.int64)),
            depths0=depths0.to(mesh.device),
            colors0=colors0.to(mesh.device),
        )

    def stage_colors(self, colors: np.ndarray) -> torch.Tensor:
        """Host voxel-table colors `[N, 3]` → this rank's `[m, B³, 3]`."""
        return stage_table_rows(self.mesh, self.layout, colors, trailing=(3,))

    def _points(self) -> torch.Tensor:
        """World positions of the rank's slots `[m·S, 3]`."""
        return self.vpos.movedim(0, -1).reshape(-1, 3).to(torch.float32) * self.voxel_size

    # ------------------------------------------------------------------
    # SVSH estimate + per-voxel interpolation
    # ------------------------------------------------------------------

    def svsh(
        self, bparams_s: Params, color_bd: torch.Tensor, lambda_reg: float, thres_shell: float
    ) -> Tuple[Optional[SVSHResult], Optional[torch.Tensor]]:
        """Sharded `estimate_svsh` + `voxel_sh_coeffs`.

        `bparams_s` is the rank's block form (`SpmdLevel.begin`,
        `place_block_params`). Returns (SVSHResult with host coefficients —
        None on the reference's estimation-failure path — and the rank's
        `[9, m, B³]` per-voxel coefficients, `optimize_level(eg_sh=)`)."""
        mesh = self.mesh
        m, s = self.valid.shape
        num_sub = self.subvolumes.count
        sdfr, normals, normal_ok = _block_normals(self.ctx.sdf_plan_s, bparams_s.sdf, pad_flat(self.valid))
        sdfr_f = sdfr.reshape(-1)
        albedo = bparams_s.albedo[:-1].reshape(-1).to(torch.float32)
        sv = self.subvol.reshape(-1)
        thres = torch.tensor(thres_shell, dtype=torch.float32, device=mesh.device)
        inside = (self.valid.reshape(-1) > 0.0) & (torch.abs(sdfr_f) <= thres)
        ok = inside & normal_ok.reshape(-1) & (albedo != 0.0) & ~torch.isnan(albedo) & (sv >= 0)
        w = sdf_to_weight(sdfr_f, torch.tensor(self.truncation, dtype=torch.float32, device=mesh.device))
        w = torch.where(ok, w, torch.zeros_like(w))
        H = sh_basis(normals.reshape(-1, 3))
        lum = intensity(color_bd.reshape(-1, 3).to(torch.float32)) / 255.0

        # per-rank partial normal equations → all-reduce → one replicated
        # solve (lighting_svsh.cpp:296-342; the 1/Σw data normalization
        # after the sum)
        a_u, b_u, wsum = normal_equation_parts(H, albedo, lum, w, torch.clamp(sv, min=0), num_sub)
        a_u = mesh.all_reduce(a_u)
        b_u = mesh.all_reduce(b_u)
        wsum = mesh.all_reduce(wsum)
        nvalid = int(mesh.all_reduce(torch.sum(ok.to(torch.int64))))
        if nvalid == 0:
            return None, None
        scale = torch.where(wsum > 0.0, 1.0 / torch.where(wsum > 0.0, wsum, torch.ones_like(wsum)),
                            torch.ones_like(wsum))
        coeffs = solve_block_system(a_u * scale, b_u * scale, self.pairs, num_sub, lambda_reg)
        coeffs = mesh.broadcast(coeffs, 0)

        cvox = trilerp_subvolumes(coeffs, self._points(), self.cell_tab, self.cell_origin, self.subvolumes.size)
        vox_sh = torch.where(inside.unsqueeze(-1), cvox, torch.zeros_like(cvox))  # [m·S, 9]
        vox_sh = vox_sh.reshape(m, s, 9).movedim(-1, 0)  # [9, m, S]
        return SVSHResult(subvolumes=self.subvolumes, coeffs=coeffs.cpu().numpy()), vox_sh

    # ------------------------------------------------------------------
    # Recolor sweep
    # ------------------------------------------------------------------

    def recolor(self, bparams_s: Params, color_bd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sharded full recolor sweep (the single-device
        `Intrinsic3D.recompute_colors`): returns the rank's new colors
        `[m, B³, 3]` and has-observation flags `[m, B³]`. Empty slots are
        not probed: their normals, and so their observation weights, are 0
        in the single-device sweep too."""
        m, s = self.valid.shape
        d = m * s
        bp = bparams_s
        sdfr, normals, _ = _block_normals(self.ctx.sdf_plan_s, bp.sdf, pad_flat(self.valid))
        cam = Camera(fx=bp.intr[0], fy=bp.intr[1], cx=bp.intr[2], cy=bp.intr[3], width=self.width,
                     height=self.height, dist=bp.dist)
        nflat = normals.reshape(d, 3)
        iso = self._points() - nflat * sdfr.reshape(d, 1)
        k = bp.poses.shape[0]
        w, uv = compute_observations_batch(
            cam, bp.poses, self.depths0, iso, nflat, self.occlusion_distance,
            active=self.occ.reshape(1, d).expand(k, d), return_uv=True,
        )  # [K, D], [K, D, 2]
        # per-voxel top-N over the frames, in place (lax.top_k's tie order)
        kcap = min(self.num_best, k)
        order = torch.argsort(-w, dim=0, stable=True)
        rank = torch.argsort(order, dim=0, stable=True)
        wsel = torch.where(rank < kcap, w, torch.zeros_like(w))
        cols = _bilinear_frame_rows(self.colors0, uv[..., 0], uv[..., 1])  # [K, D, 3]
        acc = torch.sum(cols * wsel.unsqueeze(-1), dim=0)
        wsum = torch.sum(wsel, dim=0)
        has = wsum > 0.0
        out = torch.where(has.unsqueeze(-1), acc / torch.clamp(wsum, min=1e-12).unsqueeze(-1), torch.zeros_like(acc))
        new_color = torch.where(has.unsqueeze(-1), out, color_bd.reshape(d, 3)).reshape(m, s, 3)
        return new_color, has.reshape(m, s)

    # ------------------------------------------------------------------
    # Gather at grid-level boundaries
    # ------------------------------------------------------------------

    def colors_to_table(self, color_bd: torch.Tensor, has_bd: torch.Tensor):
        """The rank's block colors → the host table (np `[N, 3]`, has `[N]`)
        on every rank (one all-gather each)."""
        slot = torch.as_tensor(self.layout.vox_slot, device=color_bd.device)
        flat = to_global(self.mesh, color_bd).reshape(-1, 3)[slot]
        has = to_global(self.mesh, has_bd.to(torch.uint8)).reshape(-1)[slot] > 0
        return flat.cpu().numpy(), has.cpu().numpy()
