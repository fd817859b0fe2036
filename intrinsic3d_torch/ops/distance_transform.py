"""Dense distance-transform sweeps: CUDA kernel and plain version.

Counterpart of `intrinsic3d_tpu/ops/pallas/distance_transform.py`
(`correct_sdf_dense`, whose Pallas kernel runs `_sweep`): `iters` Jacobi
sweeps over a dense `[X, Y, Z]` float32 SDF window and its weight field
(0 = absent or unseen). A voxel with weight > 0 takes the candidate
`nb + sgn(nb)·‖off‖·voxel_size` of the first of its 26 neighbours (dx, dy,
dz loops over −1, 0, 1) that is valid, has its sign and shrinks |sdf| below
the best so far; a voxel that takes one gets weight 1.

On CUDA tensors `correct_sdf_dense` launches `csrc/correct_sdf_dense.cu`
(built by `ops.build`) or raises; on CPU tensors it runs
`correct_sdf_dense_plain`, shifted slices of a padded tensor as `_sweep`
writes them, which the CPU tests hold against the JAX package and
`chip_smoke.py` holds the kernel against.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from intrinsic3d_torch.ops import build

# 26-neighbourhood offsets in the kernel's (and `_sweep`'s) order, and their
# Euclidean lengths
OFFSETS = np.array(
    [
        (dx, dy, dz)
        for dx in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)
        if (dx, dy, dz) != (0, 0, 0)
    ],
    np.int32,
)
_DIST = np.linalg.norm(OFFSETS.astype(np.float64), axis=-1).astype(np.float32)

_VP = ctypes.c_void_p
_SIGNATURE = [_VP] * 6 + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_float), _VP]


def step_lengths(voxel_size: float) -> np.ndarray:
    """The 26 candidate steps as the float32 product `float32(‖off‖) ·
    voxel_size`, rounded once, as the JAX package forms them."""
    return _DIST * np.float32(voxel_size)


def _sweep_plain(sdf, weight, steps):
    x, y, z = sdf.shape
    valid = weight > 0.0
    pos = sdf >= 0.0
    best_abs = torch.abs(sdf)
    best_val = sdf
    updated = torch.zeros_like(valid)
    sdf_p = F.pad(sdf[None], (1, 1, 1, 1, 1, 1))[0]
    valid_p = F.pad(valid.to(sdf.dtype)[None], (1, 1, 1, 1, 1, 1))[0] > 0.0
    for k, (dx, dy, dz) in enumerate(OFFSETS + 1):
        nb = sdf_p[dx : dx + x, dy : dy + y, dz : dz + z]
        pos_nb = nb >= 0.0
        cand = torch.where(pos_nb, nb + steps[k], nb - steps[k])
        improving = valid_p[dx : dx + x, dy : dy + y, dz : dz + z] & valid & (pos_nb == pos) & (
            torch.abs(cand) < best_abs
        )
        best_val = torch.where(improving, cand, best_val)
        best_abs = torch.where(improving, torch.abs(cand), best_abs)
        updated = updated | improving
    return best_val, torch.where(updated, torch.ones_like(weight), weight)


def correct_sdf_dense_plain(sdf, weight, voxel_size: float, iters: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """`iters` sweeps by shifted slices of a zero-padded window (26 per
    sweep): the function the kernel computes."""
    steps = torch.as_tensor(step_lengths(voxel_size), device=sdf.device)
    for _ in range(iters):
        sdf, weight = _sweep_plain(sdf, weight, steps)
    return sdf, weight


def _launch(sdf, weight, voxel_size: float, iters: int):
    if sdf.dim() != 3 or sdf.dtype != torch.float32 or weight.dtype != torch.float32:
        raise ValueError("sdf and weight must be float32 [X, Y, Z] tensors")
    if weight.shape != sdf.shape or weight.device != sdf.device:
        raise ValueError(f"weight {tuple(weight.shape)} on {weight.device} does not match sdf "
                         f"{tuple(sdf.shape)} on {sdf.device}")
    if not (sdf.is_contiguous() and weight.is_contiguous()):
        raise ValueError("sdf and weight must be contiguous")
    fn = build.load("correct_sdf_dense").i3d_correct_sdf_dense
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    out_s, out_w = torch.empty_like(sdf), torch.empty_like(weight)
    tmp_s = torch.empty_like(sdf) if iters > 1 else out_s
    tmp_w = torch.empty_like(weight) if iters > 1 else out_w
    steps = (ctypes.c_float * 26)(*step_lengths(voxel_size).tolist())
    with torch.cuda.device(sdf.device):
        rc = fn(
            sdf.data_ptr(), weight.data_ptr(), out_s.data_ptr(), out_w.data_ptr(),
            tmp_s.data_ptr(), tmp_w.data_ptr(), *sdf.shape, iters, steps,
            torch.cuda.current_stream(sdf.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"correct_sdf_dense kernel launch failed: CUDA error {rc}")
    build.LAUNCHES["correct_sdf_dense"] += iters
    return out_s, out_w


def correct_sdf_dense(sdf, weight, voxel_size: float, iters: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distance-transform correction of a dense window: new (sdf, weight),
    the inputs left as they are. On a CUDA tensor, `iters` launches of the
    sweep kernel (each counted in `build.LAUNCHES["correct_sdf_dense"]`);
    on a CPU tensor, the plain version."""
    if iters <= 0:
        return sdf.clone(), weight.clone()
    if sdf.is_cuda:
        return _launch(sdf, weight, voxel_size, iters)
    return correct_sdf_dense_plain(sdf, weight, voxel_size, iters)
