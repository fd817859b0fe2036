"""Grid-level SDF algorithms: distance-transform correction, cleanup,
thin-shell sparsification and the 2× upsample.

Counterpart of `intrinsic3d_tpu/grid/algorithms.py` (reference
``libintrinsic3d/src/sdf/algorithms.cpp``). `correct_sdf` takes one of two
routes by the JAX package's own size rule: on the card, when the grid's
dense bounding box holds at most 300 M voxels, the sparse grid is scattered
into that box on the device and corrected by the dense sweep kernel
(`ops.distance_transform.correct_sdf_dense`); otherwise the Jacobi sweeps
gather over a 26-neighbour index table. Both reach the same fixed point.
`clear_voxels_outside_thin_shell` takes its routes by the same rule (shifted
ORs and a max-pool over the dense box on the card, neighbour tables on the
host), and `upsample` is host numpy, bitwise the JAX package's.
`UpsamplePrep` builds the coordinates-only part of a grid-level boundary
(the upsample's corner lookup, child skeleton and reorder, and the child's
sparsify index tables) on a background thread while the level solves.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from intrinsic3d_torch.device import resolve_device
from intrinsic3d_torch.grid.voxel_grid import (
    RING6_OFFSETS,
    VoxelGrid,
    find_indices,
    full_neighborhood_offsets,
    pack_coords,
)
from intrinsic3d_torch.ops.distance_transform import correct_sdf_dense
from intrinsic3d_torch.prefetch import HostPrep
from intrinsic3d_torch.timer import span

_NB26 = full_neighborhood_offsets(1)
_NB26_DIST = np.linalg.norm(_NB26.astype(np.float64), axis=-1).astype(np.float32)

# the dense route's largest bounding box, in voxels (the JAX package's rule)
DENSE_MAX_VOXELS = 300_000_000


def _correct_sdf_table(sdf, weight, nbr26_idx, voxel_size: float, num_iter: int):
    """Jacobi distance-transform sweeps over a gather table
    (``algorithms.cpp:260-339``): a valid voxel takes the smallest-|·|
    candidate `sdf_nb + sgn_nb·‖Δ‖` of the valid same-sign neighbours that
    shrink |sdf|, and weight 1. Stops early once a sweep changes nothing
    (such a sweep is idempotent, so the result is the same)."""
    steps = torch.as_tensor(_NB26_DIST * np.float32(voxel_size), device=sdf.device)
    safe = torch.clamp(nbr26_idx, min=0)
    present = nbr26_idx >= 0
    for _ in range(num_iter):
        valid = weight > 0.0
        nb_ok = present & valid[safe]
        sdf_nb = sdf[safe]
        pos = sdf >= 0.0
        pos_nb = sdf_nb >= 0.0
        dist_nb = torch.where(pos_nb, sdf_nb + steps, sdf_nb - steps)
        improving = (
            nb_ok
            & (torch.abs(dist_nb) < torch.abs(sdf)[:, None])
            & (pos_nb == pos[:, None])
            & valid[:, None]
        )
        cand = torch.where(improving, torch.abs(dist_nb), torch.full_like(dist_nb, float("inf")))
        best = torch.argmin(cand, dim=-1)
        has = improving.any(dim=-1)
        if not bool(has.any()):
            break
        sdf = torch.where(has, torch.gather(dist_nb, 1, best[:, None])[:, 0], sdf)
        weight = torch.where(has, torch.ones_like(weight), weight)
    return sdf, weight


def _dense_box(grid: VoxelGrid):
    lo = grid.coords.min(axis=0)
    dims = (grid.coords.max(axis=0) - lo + 1).astype(np.int64)
    return lo, dims


def correct_sdf(grid: VoxelGrid, num_iter: int = 10, dense: bool | None = None, device="cuda") -> VoxelGrid:
    """Distance-transform correction of the fused SDF, in place on the grid,
    computed on `device`. `dense=None` picks the route: dense on the card
    when `0 < box ≤ DENSE_MAX_VOXELS`, the gather table otherwise."""
    dev = resolve_device(device)
    if grid.num_voxels == 0:
        return grid
    if dense is None:
        vol = int(np.prod(_dense_box(grid)[1]))
        dense = dev.type == "cuda" and 0 < vol <= DENSE_MAX_VOXELS
    if dense:
        return _correct_sdf_via_dense(grid, num_iter, dev)
    nbr26 = grid.neighbor_table(_NB26)
    sdf, weight = _correct_sdf_table(
        torch.as_tensor(grid.sdf, device=dev),
        torch.as_tensor(grid.weight, device=dev),
        torch.as_tensor(nbr26, dtype=torch.int64, device=dev),
        grid.voxel_size,
        num_iter,
    )
    grid.sdf = sdf.cpu().numpy()
    grid.weight = weight.cpu().numpy()
    return grid


def _correct_sdf_via_dense(grid: VoxelGrid, num_iter: int, dev: torch.device) -> VoxelGrid:
    """Scatter the sparse grid into its dense box on `dev` (0 = absent),
    run the dense sweeps, gather back."""
    lo, dims = _dense_box(grid)
    c = torch.as_tensor(grid.coords - lo, dtype=torch.int64, device=dev)
    flat = (c[:, 0] * int(dims[1]) + c[:, 1]) * int(dims[2]) + c[:, 2]
    shape = tuple(int(d) for d in dims)
    dense_sdf = torch.zeros(shape, dtype=torch.float32, device=dev)
    dense_w = torch.zeros(shape, dtype=torch.float32, device=dev)
    dense_sdf.view(-1)[flat] = torch.as_tensor(grid.sdf, dtype=torch.float32, device=dev)
    dense_w.view(-1)[flat] = torch.as_tensor(grid.weight, dtype=torch.float32, device=dev)
    out_s, out_w = correct_sdf_dense(dense_sdf, dense_w, grid.voxel_size, num_iter)
    grid.sdf = out_s.view(-1)[flat].cpu().numpy()
    grid.weight = out_w.view(-1)[flat].cpu().numpy()
    return grid


def clear_invalid_voxels(grid: VoxelGrid) -> VoxelGrid:
    """Drop voxels with weight ≤ 0 (``algorithms.cpp:342-365``)."""
    return grid.select(grid.valid_mask())


def apply_refined_sdf(grid: VoxelGrid) -> VoxelGrid:
    """`sdf ← sdf_refined` (``algorithms.cpp:250-257``)."""
    grid.sdf = grid.sdf_refined.copy()
    return grid


# ---------------------------------------------------------------------------
# Thin-shell sparsification
# ---------------------------------------------------------------------------

# the reference's keep-stencil: 6-ring plus (+2,0,0),(0,+2,0),(0,0,+2)
# (``algorithms.cpp:380-385``) — the forward-difference support of E_g
_SHELL_SUPPORT = np.concatenate([RING6_OFFSETS, np.array([[2, 0, 0], [0, 2, 0], [0, 0, 2]], np.int32)], axis=0)
_NB_CROSS = full_neighborhood_offsets(2)


class ShellInputs(NamedTuple):
    """What the thin-shell sparsify of `grid` reads from its coordinates
    alone, for one route: the dense box's shape (a 2-voxel margin included)
    and each voxel's flat index in it, or the host route's support table.
    Numpy only (`UpsamplePrep` builds them on its thread)."""

    grid: VoxelGrid  # the grid they were built for
    dense: bool
    shape: Optional[tuple] = None  # box shape
    flat: Optional[np.ndarray] = None  # [N] int64 flat index of each voxel in the box
    support: Optional[np.ndarray] = None  # [N, 9] neighbour table of the keep-stencil


def _shell_route(grid: VoxelGrid, dense: Optional[bool], dev: torch.device) -> bool:
    """The sparsify's route: `dense` when given, else the dense box on the
    card when `0 < box ≤ DENSE_MAX_VOXELS` (`correct_sdf`'s rule)."""
    if dense is None:
        vol = int(np.prod(_dense_box(grid)[1] + 4))
        dense = dev.type == "cuda" and 0 < vol <= DENSE_MAX_VOXELS
    return dense


def shell_inputs(grid: VoxelGrid, dense: bool) -> ShellInputs:
    """`ShellInputs` of a non-empty grid on the dense or the host route."""
    if not dense:
        return ShellInputs(grid=grid, dense=False, support=grid.neighbor_table(_SHELL_SUPPORT))
    lo, dims = _dense_box(grid)
    lo = lo - 2
    shape = tuple(int(d) + 4 for d in dims)
    c = grid.coords.astype(np.int64) - lo
    flat = (c[:, 0] * shape[1] + c[:, 1]) * shape[2] + c[:, 2]
    return ShellInputs(grid=grid, dense=True, shape=shape, flat=flat)


def _thin_shell_keep_table(grid: VoxelGrid, thres_shell: float, shell: ShellInputs) -> np.ndarray:
    """Host route: the keep mask from the 9-offset support table and, for
    the voxels not yet kept, the 124-neighbour zero-crossing table."""
    sdfr = grid.sdf_refined
    core = grid.valid_mask() & (np.abs(sdfr) <= thres_shell)
    keep = core.copy()
    touched = shell.support[core].reshape(-1)
    keep[touched[touched >= 0]] = True
    rest = np.flatnonzero(~keep)
    if len(rest):
        nb_idx = find_indices(grid.keys, grid.coords[rest][:, None, :] + _NB_CROSS[None, :, :])  # [M, 124]
        present = nb_idx >= 0
        nb_sdf = sdfr[np.maximum(nb_idx, 0)]
        has_pos = np.any(present & (nb_sdf >= 0.0), axis=-1)
        has_neg = np.any(present & (nb_sdf < 0.0), axis=-1)
        keep[rest[np.where(sdfr[rest] < 0.0, has_pos, has_neg)]] = True
    return keep


def _thin_shell_keep_dense(grid: VoxelGrid, thres_shell: float, dev: torch.device, shell: ShellInputs) -> np.ndarray:
    """Dense route: the grid scattered into its bounding box (plus a 2-voxel
    margin) on `dev`. The support is 9 shifted ORs of the core mask
    (keep[u] ⇐ core[u − off]); the zero-crossing test is a 5³ max-pool over
    the sign masks of the present voxels. The pool includes the center,
    which cannot fake a crossing: a voxel's own sign never tests against
    itself. The shell threshold is compared in float64, as on the host."""
    shape = shell.shape
    flat = torch.as_tensor(shell.flat, device=dev)
    sdfr = torch.as_tensor(grid.sdf_refined, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(grid.valid_mask(), device=dev)

    def dense(vals):
        out = torch.zeros(shape, dtype=vals.dtype, device=dev)
        out.view(-1)[flat] = vals
        return out

    core = dense(valid & (torch.abs(sdfr).to(torch.float64) <= thres_shell))
    keep = core.clone()
    nx, ny, nz = shape
    for ox, oy, oz in _SHELL_SUPPORT.tolist():
        # keep[u] |= core[u - off]; the 2-voxel margin keeps every source in the box
        keep[max(ox, 0) : nx + min(ox, 0), max(oy, 0) : ny + min(oy, 0), max(oz, 0) : nz + min(oz, 0)] |= core[
            max(-ox, 0) : nx + min(-ox, 0), max(-oy, 0) : ny + min(-oy, 0), max(-oz, 0) : nz + min(-oz, 0)
        ]
    pos = dense(sdfr >= 0.0).to(torch.float32)
    neg = dense(sdfr < 0.0).to(torch.float32)
    pool = lambda m: F.max_pool3d(m[None, None], kernel_size=5, stride=1, padding=2)[0, 0] > 0.0  # noqa: E731
    crossing = torch.where(dense(sdfr < 0.0), pool(pos), pool(neg))
    return (keep | crossing).view(-1)[flat].cpu().numpy()


def clear_voxels_outside_thin_shell(
    grid: VoxelGrid, thres_shell: float, dense: bool | None = None, device="cuda", shell: ShellInputs | None = None
) -> VoxelGrid:
    """Keep (a) valid voxels with |sdf_refined| ≤ thres plus their stencil
    support, and (b) voxels with a zero-crossing in their 5³ neighbourhood
    (``algorithms.cpp:368-458``). `dense=None` picks the route by
    `correct_sdf`'s rule: the dense box on the card when `0 < box ≤
    DENSE_MAX_VOXELS`, the host neighbour tables otherwise. Both routes keep
    the same voxel set (the predicate is boolean). `shell` (prebuilt by
    `UpsamplePrep.shell_for`) supplies the route and its index tables; it
    must be this grid's."""
    dev = resolve_device(device)
    if grid.num_voxels == 0:
        return grid
    if shell is None:
        shell = shell_inputs(grid, _shell_route(grid, dense, dev))
    elif shell.grid is not grid:
        raise ValueError("the prebuilt thin-shell inputs belong to another grid")
    elif dense is not None and dense != shell.dense:
        raise ValueError(f"dense={dense} against prebuilt inputs of the {'dense' if shell.dense else 'host'} route")
    if shell.dense:
        keep = _thin_shell_keep_dense(grid, thres_shell, dev, shell)
    else:
        keep = _thin_shell_keep_table(grid, thres_shell, shell)
    return grid.select(keep)


# ---------------------------------------------------------------------------
# Trilinear resampling and 2× upsample (host numpy, copies of the JAX
# package's functions with their accumulation order)
# ---------------------------------------------------------------------------

_CORNER_OFFS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 1], [1, 0, 1], [1, 1, 1]],
    np.int32,
)


def interpolate_fields(grid: VoxelGrid, positions: np.ndarray) -> dict:
    """Trilinear interpolation of all voxel fields at continuous grid
    positions `[M, 3]` (``algorithms.cpp:118-199``): invalid corners get zero
    weight; ≤ 4 valid corners zero the interpolated weight. Returns a dict
    of field arrays."""
    pos = np.asarray(positions, np.float64)
    base = np.floor(pos).astype(np.int64)
    frac = (pos - base).astype(np.float32)
    corners = base[:, None, :] + _CORNER_OFFS[None, :, :]  # [M, 8, 3]
    w = np.where(_CORNER_OFFS[None, :, :] == 1, frac[:, None, :], 1.0 - frac[:, None, :]).prod(axis=-1)
    idx = grid.lookup(corners)  # [M, 8]
    valid = (idx >= 0) & (grid.weight[np.maximum(idx, 0)] > 0.0)
    w = np.where(valid, w, 0.0)
    cnt = valid.sum(axis=-1)
    wsum = w.sum(axis=-1)
    wsafe = np.where(wsum > 0.0, wsum, 1.0)

    def avg(field):
        vals = field[np.maximum(idx, 0)]
        if vals.ndim == 3:
            return (vals * w[..., None]).sum(axis=1) / wsafe[:, None]
        return (vals * w).sum(axis=1) / wsafe

    out = {
        "sdf": avg(grid.sdf.astype(np.float32)),
        "color": avg(grid.color),
        "weight": np.maximum(np.where(cnt > 4, avg(grid.weight), 0.0), 0.0),
    }
    if grid.is_sbr:
        out["albedo"] = avg(grid.albedo)
        out["sdf_refined"] = avg(grid.sdf_refined)
    return out


# Per-(child, corner) trilinear weights of the 2× upsample: child c sits at
# parent + offs_c/2, so every child of a parent reads the same 8 corners with
# weights 0.5^popcount — a fixed [8, 8] table, binary-exact, so the result is
# bitwise `interpolate_fields` at the child positions
_UP_W8 = np.where(
    _CORNER_OFFS[None, :, :] == 1,
    (_CORNER_OFFS[:, None, :] * 0.5).astype(np.float32),
    (1.0 - _CORNER_OFFS[:, None, :] * 0.5).astype(np.float32),
).prod(axis=-1)  # [child c, corner k]


def _upsample_fields(grid: VoxelGrid, idx: np.ndarray) -> dict:
    """Field resampling of `upsample` from the `[N, 8]` parent-corner lookup
    `idx` and the fixed `_UP_W8` table. The corner sums follow numpy's own
    reduction order in `interpolate_fields` — the pairwise tree
    ((0+1)+(2+3))+((4+5)+(6+7)) for scalar fields, sequential for color —
    so both stay bitwise equal."""
    valid = (idx >= 0) & (grid.weight[np.maximum(idx, 0)] > 0.0)
    w = np.where(valid[:, None, :], _UP_W8[None, :, :], 0.0)  # [N, c, k]
    cnt = valid.sum(axis=-1)  # the same for all 8 children of a parent
    wsum = w.sum(axis=-1)  # [N, c]
    wsafe = np.where(wsum > 0.0, wsum, 1.0)

    def avg(field):
        vals = field[np.maximum(idx, 0)]  # [N, 8] or [N, 8, 3]
        if vals.ndim == 3:
            s = vals[:, None, 0, :] * w[:, :, 0, None]
            for k in range(1, 8):
                s = s + vals[:, None, k, :] * w[:, :, k, None]
            return (s / wsafe[..., None]).reshape(-1, 3)

        def term(k):
            return vals[:, None, k] * w[:, :, k]

        pair = [term(2 * i) + term(2 * i + 1) for i in range(4)]
        s = (pair[0] + pair[1]) + (pair[2] + pair[3])
        return (s / wsafe).reshape(-1)

    out = {
        "sdf": avg(grid.sdf.astype(np.float32)),
        "color": avg(grid.color),
        "weight": np.maximum(
            np.where((cnt > 4)[:, None], avg(grid.weight).reshape(len(idx), 8), 0.0), 0.0
        ).reshape(-1),
    }
    if grid.is_sbr:
        out["albedo"] = avg(grid.albedo)
        out["sdf_refined"] = avg(grid.sdf_refined)
    return out


def _upsample_skeleton(grid: VoxelGrid):
    """The coordinates-only part of `upsample`: the `[N, 8]` parent-corner
    lookup, the child grid with zero fields (key-sorted by `from_coords`)
    and the permutation that puts the children's fields in its order."""
    parent = grid.coords.astype(np.int64)
    idx = grid.lookup(parent[:, None, :] + _CORNER_OFFS[None, :, :])
    child_coords = ((2 * parent)[:, None, :] + _CORNER_OFFS[None, :, :]).reshape(-1, 3)
    up = VoxelGrid.from_coords(grid.voxel_size * 0.5, child_coords, grid.depth_min, grid.depth_max, sbr=grid.is_sbr)
    order = np.argsort(pack_coords(child_coords), kind="stable")
    return idx, up, order


def upsample(grid: VoxelGrid, prep: Optional["UpsamplePrep"] = None) -> VoxelGrid:
    """2× refinement: each voxel spawns 8 children at half the voxel size,
    fields trilinearly resampled from the parent grid
    (``algorithms.cpp:202-237``). Host numpy. `prep` (an `UpsamplePrep` of
    this grid) supplies the coordinates-only part built in the background;
    the result is bitwise the same. The field resampling runs in an
    `upsample.fields` span (`timer.span`)."""
    if prep is not None:
        if not prep.ok(grid):
            raise ValueError("the upsample prep belongs to another grid, or its child grid was already returned")
        prep.taken = True
        idx, up, order = prep.idx, prep.up, prep.order
    else:
        idx, up, order = _upsample_skeleton(grid)
    with span("upsample.fields"):
        fields = _upsample_fields(grid, idx=idx)
    up.sdf = fields["sdf"][order].astype(np.float32)
    up.weight = fields["weight"][order].astype(np.float32)
    up.color = fields["color"][order].astype(np.float32)
    if grid.is_sbr:
        up.albedo = fields["albedo"][order].astype(np.float32)
        up.sdf_refined = fields["sdf_refined"][order].astype(np.float32)
    up.integration_weight_sample = grid.integration_weight_sample
    return up


class UpsamplePrep(HostPrep):
    """The coordinates-only part of a grid-level boundary, built on a
    background thread: the counterpart of
    `intrinsic3d_tpu/grid/algorithms.py::UpsamplePrep` without its program
    warm-up.

    The boundary runs solve → recolor → ×2 `upsample` → thin-shell
    sparsify, and the upsample's corner lookup, child skeleton and reorder
    permutation, and the child's sparsify index tables (`ShellInputs` on
    the route `dense`/`device` pick, as `clear_voxels_outside_thin_shell`
    would) depend only on voxel coordinates, which the solve and recolor
    never change. Started when the level's solve starts, the thread builds
    them on the host; `upsample(grid, prep=)` and
    `clear_voxels_outside_thin_shell(shell=prep.shell_for(child))` take
    them, with bitwise the same results. Field resampling, which needs the
    solved fields, stays in `upsample`."""

    def __init__(self, grid: VoxelGrid, dense: Optional[bool] = None, device="cuda"):
        self.grid = grid
        self.idx = None  # [N, 8] parent-corner lookup
        self.up = None  # the child grid, zero fields
        self.order = None  # [8N] field reorder
        self.shell = None  # the child's ShellInputs
        self.taken = False  # `upsample` returned `up`
        self._dense = dense
        self._dev = resolve_device(device)
        super().__init__(f"upsample v{grid.num_voxels}")

    def _prepare(self) -> None:
        idx, up, order = _upsample_skeleton(self.grid)
        if up.num_voxels:
            self.shell = shell_inputs(up, _shell_route(up, self._dense, self._dev))
        self.idx, self.up, self.order = idx, up, order

    def ok(self, grid: VoxelGrid) -> bool:
        """Joined (its exception re-raised), built for the parent `grid`
        and its child grid not yet returned by `upsample`?"""
        self.join()
        return self.grid is grid and not self.taken

    def shell_for(self, grid: VoxelGrid) -> Optional[ShellInputs]:
        """The prebuilt sparsify inputs, iff `grid` IS the child grid this
        prep produced (the object `upsample(..., prep=self)` returned);
        None for any other grid."""
        self.join()
        return self.shell if self.taken and self.up is grid else None
