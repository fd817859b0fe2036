"""Uniform spatial subvolume partition for spatially-varying SH lighting
(host numpy).

Copy of `intrinsic3d_tpu/lighting/subvolumes.py` (reference
``libintrinsic3d/src/lighting/subvolumes.cpp``): occupied cells of a uniform
`subvolume_size` partition are discovered from the voxel table in one
vectorized pass; the per-voxel subvolume id, the 1-ring neighbour pair list
(the coefficient regularizer's topology) and trilinear interpolation of
per-subvolume values at arbitrary points (−0.5 center offset,
missing-neighbour weight zeroing, ``subvolumes.cpp:164-208``) are plain
array programs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from intrinsic3d_torch.grid.voxel_grid import RING6_OFFSETS, pack_coords, unpack_keys


def _find(sorted_keys: np.ndarray, query_keys: np.ndarray) -> np.ndarray:
    pos = np.searchsorted(sorted_keys, query_keys)
    pos_c = np.clip(pos, 0, max(len(sorted_keys) - 1, 0))
    hit = (
        (pos < len(sorted_keys)) & (sorted_keys[pos_c] == query_keys)
        if len(sorted_keys)
        else np.zeros(len(query_keys), bool)
    )
    return np.where(hit, pos_c, -1).astype(np.int32)


@dataclasses.dataclass
class Subvolumes:
    """Occupied subvolume cells with id lookup."""

    size: float  # subvolume edge length in meters
    indices: np.ndarray  # [S, 3] int cell indices, key-sorted
    keys: np.ndarray  # [S] packed keys

    @classmethod
    def compute(cls, world_pts: np.ndarray, size: float) -> "Subvolumes":
        """Discover occupied cells from voxel world positions
        (``subvolumes.cpp:211-239``)."""
        idx = np.floor(np.asarray(world_pts, np.float64) / size).astype(np.int64)
        keys = np.unique(pack_coords(idx))
        return cls(size=float(size), indices=unpack_keys(keys), keys=keys)

    @property
    def count(self) -> int:
        return len(self.keys)

    def point_to_subvolume(self, pts: np.ndarray) -> np.ndarray:
        """Subvolume id of each point (−1 if in no occupied cell)
        (``subvolumes.cpp:143-161``)."""
        idx = np.floor(np.asarray(pts, np.float64) / self.size).astype(np.int64)
        return _find(self.keys, pack_coords(idx))

    def neighbor_pairs(self) -> np.ndarray:
        """Directed 1-ring neighbour pairs `[P, 2]` of subvolume ids — the
        regularizer topology (``lighting_svsh.cpp:256-289``: each direction
        contributes its own residual)."""
        nb = self.indices[:, None, :] + RING6_OFFSETS[None, :, :].astype(np.int64)
        nb_id = _find(self.keys, pack_coords(nb.reshape(-1, 3))).reshape(-1, 6)
        src = np.repeat(np.arange(self.count), 6)
        dst = nb_id.reshape(-1)
        ok = dst >= 0
        return np.stack([src[ok], dst[ok]], axis=-1).astype(np.int32)

    def cell_lookup(self, pad: int = 1):
        """Dense int32 lookup volume over the occupied cells' bounding box
        (+`pad` margin): `table[i - origin] = subvolume id`, −1 for empty
        cells — the device-side lookup of `svsh.trilerp_subvolumes`'s corner
        queries. Cells are `size` (~0.2 m) wide, so the box is a few KB."""
        lo = self.indices.min(axis=0) - pad
        hi = self.indices.max(axis=0) + pad
        dims = hi - lo + 1
        tab = np.full(tuple(dims), -1, np.int32)
        idx = self.indices - lo
        tab[idx[:, 0], idx[:, 1], idx[:, 2]] = np.arange(self.count, dtype=np.int32)
        return tab, lo.astype(np.int64)

    def interpolation(self, pts: np.ndarray):
        """Trilinear interpolation stencil at points `[M, 3]`: returns
        (ids [M, 8] int32 with −1 absent, weights [M, 8] normalized)
        (``subvolumes.cpp:164-208``: −0.5 center offset, zero weight for
        missing cells, renormalized)."""
        pos = np.asarray(pts, np.float64) / self.size - 0.5
        base = np.floor(pos).astype(np.int64)
        frac = pos - base
        offs = np.array(
            [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 1], [1, 0, 1], [1, 1, 1]],
            np.int64,
        )
        corners = base[:, None, :] + offs[None, :, :]
        w = np.where(offs[None, :, :] == 1, frac[:, None, :], 1.0 - frac[:, None, :]).prod(axis=-1)
        ids = _find(self.keys, pack_coords(corners.reshape(-1, 3))).reshape(-1, 8)
        w = np.where(ids >= 0, w, 0.0)
        wsum = w.sum(axis=-1, keepdims=True)
        w = np.where(wsum > 0.0, w / np.where(wsum == 0.0, 1.0, wsum), 0.0)
        return ids, w.astype(np.float32)

    def interpolate_values(self, values: np.ndarray, pts: np.ndarray) -> np.ndarray:
        """Interpolate per-subvolume vectors `values [S, D]` at points."""
        ids, w = self.interpolation(pts)
        vals = values[np.maximum(ids, 0)]
        return (vals * w[..., None]).sum(axis=1)
