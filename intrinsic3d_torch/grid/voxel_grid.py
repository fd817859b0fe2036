"""Flat sorted voxel table (host numpy).

Copy of the numpy part of `intrinsic3d_tpu/grid/voxel_grid.py`: packed
coordinate keys, the stencil offset tables, `find_indices` by vectorized
binary search, and the `VoxelGrid` record with the structural helpers the
refinement slice uses. TSDF I/O and the native C++ lookup stay in the JAX
package until the port reaches them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# 21 bits per axis, offset so coordinates in [-2^20, 2^20) pack monotonically
_BIAS = 1 << 20
_MASK_BITS = 21


def pack_coords(coords: np.ndarray) -> np.ndarray:
    """Pack int voxel coords `[N, 3]` into sortable int64 keys."""
    c = coords.astype(np.int64) + _BIAS
    if np.any((c < 0) | (c >= (1 << _MASK_BITS))):
        raise ValueError("voxel coordinates out of packable range ±2^20")
    return (c[:, 0] << (2 * _MASK_BITS)) | (c[:, 1] << _MASK_BITS) | c[:, 2]


def unpack_keys(keys: np.ndarray) -> np.ndarray:
    m = (1 << _MASK_BITS) - 1
    x = (keys >> (2 * _MASK_BITS)) & m
    y = (keys >> _MASK_BITS) & m
    z = keys & m
    return np.stack([x, y, z], axis=-1).astype(np.int64) - _BIAS


def find_indices(sorted_keys: np.ndarray, query_coords: np.ndarray) -> np.ndarray:
    """Indices of query voxel coords `[..., 3]` in the table; −1 where absent."""
    shape = query_coords.shape[:-1]
    q = query_coords.reshape(-1, 3)
    qk = pack_coords(q)
    if len(sorted_keys) == 0:
        return np.full(shape, -1, np.int32)
    pos = np.searchsorted(sorted_keys, qk)
    pos_c = np.clip(pos, 0, len(sorted_keys) - 1)
    hit = (pos < len(sorted_keys)) & (sorted_keys[pos_c] == qk)
    return np.where(hit, pos_c, -1).astype(np.int32).reshape(shape)


# 6-neighborhood in the reference's order (+x, −x, +y, −y, +z, −z)
RING6_OFFSETS = np.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], dtype=np.int32
)

# forward-difference normal stencil: center, +x, +y, +z
NORMAL_OFFSETS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=np.int32)

# the 10-voxel SDF stencil of the shading cost, in the reference's parameter
# order (``shading_cost.cpp:87-110``)
EG_SDF_OFFSETS = np.array(
    [
        [0, 0, 0],
        [0, 1, 0],
        [0, 2, 0],
        [0, 1, 1],
        [0, 0, 1],
        [0, 0, 2],
        [1, 0, 0],
        [1, 1, 0],
        [1, 0, 1],
        [2, 0, 0],
    ],
    dtype=np.int32,
)

# the 4 albedo parameters of the shading cost: center, +x, +y, +z
EG_ALBEDO_OFFSETS = NORMAL_OFFSETS


@dataclasses.dataclass
class VoxelGrid:
    """Sorted voxel table with SoA fields (`VoxelSBR`,
    ``sparse_voxel_grid.h:69-77``): color is float32 RGB in [0, 255]."""

    voxel_size: float
    coords: np.ndarray  # [N, 3] int32, key-sorted
    keys: np.ndarray  # [N] int64, sorted
    sdf: np.ndarray  # [N] f32
    weight: np.ndarray  # [N] f32
    color: np.ndarray  # [N, 3] f32, 0..255
    albedo: Optional[np.ndarray] = None  # [N] f32
    sdf_refined: Optional[np.ndarray] = None  # [N] f32
    depth_min: float = 0.1
    depth_max: float = 10.0
    integration_weight_sample: float = 10.0

    @property
    def truncation(self) -> float:
        return self.voxel_size * 5.0

    @property
    def num_voxels(self) -> int:
        return int(self.coords.shape[0])

    @classmethod
    def from_coords(
        cls,
        voxel_size: float,
        coords: np.ndarray,
        depth_min: float = 0.1,
        depth_max: float = 10.0,
        sbr: bool = False,
    ) -> "VoxelGrid":
        coords = np.asarray(coords, dtype=np.int32).reshape(-1, 3)
        keys = pack_coords(coords)
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        coords = np.ascontiguousarray(coords[order])
        n = len(coords)
        g = cls(
            voxel_size=float(voxel_size),
            coords=coords,
            keys=keys,
            sdf=np.zeros(n, np.float32),
            weight=np.zeros(n, np.float32),
            color=np.zeros((n, 3), np.float32),
            depth_min=depth_min,
            depth_max=depth_max,
        )
        if sbr:
            g.albedo = np.full(n, 0.6, np.float32)
            g.sdf_refined = np.zeros(n, np.float32)
        return g

    def neighbor_table(self, offsets: np.ndarray) -> np.ndarray:
        """Gather-index table `[N, S]` for stencil offsets `[S, 3]`; −1 absent."""
        q = self.coords[:, None, :] + np.asarray(offsets, np.int32)[None, :, :]
        return find_indices(self.keys, q)

    def valid_mask(self) -> np.ndarray:
        """Per-voxel `weight > 0` (``sparse_voxel_grid.cpp:253-259``)."""
        return self.weight > 0.0

    def voxel_to_world(self, coords=None) -> np.ndarray:
        c = self.coords if coords is None else np.asarray(coords)
        return c.astype(np.float32) * np.float32(self.voxel_size)

    def select(self, mask_or_indices) -> "VoxelGrid":
        """New grid containing the selected voxels (sorted order preserved)."""
        idx = (
            np.flatnonzero(mask_or_indices)
            if np.asarray(mask_or_indices).dtype == bool
            else np.asarray(mask_or_indices)
        )
        return VoxelGrid(
            voxel_size=self.voxel_size,
            coords=np.ascontiguousarray(self.coords[idx]),
            keys=self.keys[idx],
            sdf=self.sdf[idx].copy(),
            weight=self.weight[idx].copy(),
            color=self.color[idx].copy(),
            albedo=None if self.albedo is None else self.albedo[idx].copy(),
            sdf_refined=None if self.sdf_refined is None else self.sdf_refined[idx].copy(),
            depth_min=self.depth_min,
            depth_max=self.depth_max,
            integration_weight_sample=self.integration_weight_sample,
        )
