"""Binary `.tsdf` volume format, byte-compatible with the reference.

Reference format (``libintrinsic3d/src/sparse_voxel_grid.cpp:483-569``):

    float32 voxel_size, float32 truncation, float32 integration_weight_sample,
    uint64 num_voxels, float32 max_load_factor,
    then per voxel: int32[3] coords + the raw C struct.

Struct layouts (x86-64 padding, ``include/nv/sparse_voxel_grid.h:56-77``):
  Voxel    (12 B): f32 sdf, f32 weight, u8 color[3], 1 pad byte
  VoxelSBR (32 B): f64 sdf, f32 weight, u8 color[3], 1 pad, f64 albedo,
                   f64 sdf_refined

Reading/writing goes through numpy structured dtypes — no Python loops.

Copy of `intrinsic3d_tpu/io/tsdf_io.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

VOXEL_DTYPE = np.dtype(
    {
        "names": ["coords", "sdf", "weight", "color"],
        "formats": [("<i4", (3,)), "<f4", "<f4", ("u1", (3,))],
        "offsets": [0, 12, 16, 20],
        "itemsize": 24,
    }
)

VOXEL_SBR_DTYPE = np.dtype(
    {
        "names": ["coords", "sdf", "weight", "color", "albedo", "sdf_refined"],
        "formats": [("<i4", (3,)), "<f8", "<f4", ("u1", (3,)), "<f8", "<f8"],
        "offsets": [0, 12, 20, 24, 28, 36],
        "itemsize": 44,
    }
)
# NOTE on VOXEL_SBR_DTYPE: in the C++ file the record is int32[3] followed by the
# 32-byte VoxelSBR struct whose double members are 8-aligned *within the struct*
# (offsets 0, 16, 24 inside the struct → absolute 12, 28, 36 in the record).


@dataclasses.dataclass
class TsdfVolume:
    """Host-side plain-array view of a sparse TSDF volume."""

    voxel_size: float
    truncation: float
    integration_weight_sample: float
    coords: np.ndarray  # [N, 3] int32
    sdf: np.ndarray  # [N] f32/f64
    weight: np.ndarray  # [N] f32
    color: np.ndarray  # [N, 3] u8 (0..255)
    albedo: np.ndarray | None = None  # [N] (VoxelSBR only)
    sdf_refined: np.ndarray | None = None  # [N] (VoxelSBR only)

    @property
    def num_voxels(self) -> int:
        return int(self.coords.shape[0])

    @property
    def is_sbr(self) -> bool:
        return self.albedo is not None


def _read_header(f) -> Tuple[float, float, float, int]:
    head = np.frombuffer(f.read(12), dtype="<f4")
    voxel_size, truncation, weight_sample = (float(x) for x in head)
    n = int(np.frombuffer(f.read(8), dtype="<u8")[0])
    f.read(4)  # max_load_factor (ignored)
    return voxel_size, truncation, weight_sample, n


def load_tsdf(filename: str, sbr: bool | None = None) -> TsdfVolume:
    """Load a `.tsdf` file. If `sbr` is None, the voxel type is inferred from
    the record size."""
    with open(filename, "rb") as f:
        voxel_size, truncation, weight_sample, n = _read_header(f)
        payload = f.read()
    if sbr is None:
        if n > 0 and len(payload) % n == 0:
            rec = len(payload) // n
            sbr = rec == VOXEL_SBR_DTYPE.itemsize
        else:
            sbr = False
    dtype = VOXEL_SBR_DTYPE if sbr else VOXEL_DTYPE
    arr = np.frombuffer(payload[: n * dtype.itemsize], dtype=dtype)
    vol = TsdfVolume(
        voxel_size=voxel_size,
        truncation=truncation,
        integration_weight_sample=weight_sample,
        coords=np.ascontiguousarray(arr["coords"]),
        sdf=np.ascontiguousarray(arr["sdf"]),
        weight=np.ascontiguousarray(arr["weight"]),
        color=np.ascontiguousarray(arr["color"]),
    )
    if sbr:
        vol.albedo = np.ascontiguousarray(arr["albedo"])
        vol.sdf_refined = np.ascontiguousarray(arr["sdf_refined"])
    return vol


def save_tsdf(filename: str, vol: TsdfVolume) -> None:
    n = vol.num_voxels
    dtype = VOXEL_SBR_DTYPE if vol.is_sbr else VOXEL_DTYPE
    arr = np.zeros(n, dtype=dtype)
    arr["coords"] = vol.coords.astype(np.int32)
    arr["sdf"] = vol.sdf
    arr["weight"] = vol.weight.astype(np.float32)
    arr["color"] = np.clip(vol.color, 0, 255).astype(np.uint8)
    if vol.is_sbr:
        arr["albedo"] = vol.albedo
        arr["sdf_refined"] = vol.sdf_refined
    with open(filename, "wb") as f:
        f.write(
            np.array(
                [vol.voxel_size, vol.truncation, vol.integration_weight_sample], dtype="<f4"
            ).tobytes()
        )
        f.write(np.array([n], dtype="<u8").tobytes())
        f.write(np.array([0.6], dtype="<f4").tobytes())  # max_load_factor
        f.write(arr.tobytes())
