"""Dense distance-transform sweeps: CUDA kernel and plain version.

Counterpart of `intrinsic3d_tpu/ops/pallas/distance_transform.py`
(`correct_sdf_dense`, whose Pallas kernel runs `_sweep`): `iters` Jacobi
sweeps over a dense `[X, Y, Z]` float32 SDF window and its weight field
(0 = absent or unseen). A voxel with weight > 0 takes the candidate
`nb + sgn(nb)·‖off‖·voxel_size` of the first of its 26 neighbours (dx, dy,
dz loops over −1, 0, 1) that is valid, has its sign and shrinks |sdf| below
the best so far; a voxel that takes one gets weight 1.

On CUDA tensors `correct_sdf_dense` runs the launches of `sweep_plan` on
`csrc/correct_sdf_dense.cu` (built by `ops.build`), each fusing several
sweeps in shared memory behind a halo as deep, or raises; on CPU tensors it
runs `correct_sdf_dense_plain`, shifted slices of a padded tensor as
`_sweep` writes them, which the CPU tests hold against the JAX package and
`chip_smoke.py` holds the kernel against.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

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
_SIGNATURE = ([_VP] * 6 + [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3
              + [ctypes.POINTER(ctypes.c_float), _VP])


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


# The plan: how many sweeps each launch fuses and how the kernel's blocks cut
# the window, taken from the timings of `tools/profile_torch_dt.py` on the
# H100 (PERF.md, PR 3); not a setting. A small window is bound by the
# latency of each block's march and takes few sweeps a launch on short
# segments (the fusion path's 73x63x73 window); a large one is bound by its
# passes over device memory and takes more (the 411x211x501 field). On
# sphere-band fields the large plan's time fell from 1.19x the small plan's
# at 15.0 M voxels to 0.85x at 26.6 M (`--crossover`), so the switch is at
# 20 M, where the two cross when interpolated; between those sizes it is not
# timed.
#
# The kernel's limits, which its C entry enforces (it launches nothing for a
# plan beyond them): here for the plan to stay inside them and its tests to
# say so.
SMEM_BYTES = 232_448  # dynamic shared memory a block may use on the H100
MAX_THREADS = 768     # the kernel's launch bound
MAX_SWEEPS = 8        # sweeps a launch may fuse (the kernel's bit masks)
ROWS = 4              # rows of a column a lane sweeps (V in the source)
LARGE_FROM_VOXELS = 20_000_000  # windows of more voxels take LARGE_PLAN
# (sweeps a launch, interior rows, level-0 columns, x-planes)
SMALL_PLAN = (2, 12, 32, 4)
LARGE_PLAN = (5, 16, 96, 64)


class SweepPlan(NamedTuple):
    """The launches of one `correct_sdf_dense` call on the card: launch i
    fuses `sweeps[i]` sweeps. A launch of k sweeps cuts the window into
    blocks of `tile_y` rows, `cols - 2k` columns and `seg` planes of
    interior, each swept on its interior plus a k-deep halo by `cols / 32`
    x `ceil((tile_y + 2k) / ROWS)` warps."""

    sweeps: Tuple[int, ...]
    tile_y: int
    cols: int
    seg: int

    def tile_z(self, k: int) -> int:
        return self.cols - 2 * k

    def grid(self, shape, k: int) -> Tuple[int, int, int]:
        """Blocks of a launch of k sweeps along z, y and x."""
        x, y, z = (int(v) for v in shape)
        return -(-z // self.tile_z(k)), -(-y // self.tile_y), -(-x // self.seg)

    def blocks(self, shape) -> int:
        return int(np.prod(self.grid(shape, self.sweeps[0]))) if self.sweeps else 0

    def threads(self, k: int) -> int:
        return self.cols * -(-(self.tile_y + 2 * k) // ROWS)


def smem_bytes(k: int, tile_y: int, cols: int) -> int:
    """Shared memory of a launch of k sweeps (as `smem_bytes` in the
    source): 4 planes of each level below k, level s over tile_y + 2(k - s)
    rows."""
    ey = tile_y + 2 * k
    return 16 * cols * (k * ey - k * (k - 1))


def sweep_plan(shape, iters: int) -> SweepPlan:
    """`ceil(iters / k)` launches sharing the sweeps evenly, k and the block
    shape from SMALL_PLAN or LARGE_PLAN by the window's size, blocks cut to
    the window where it is narrower."""
    x, y, z = (int(v) for v in shape)
    return plan_from(shape, iters, SMALL_PLAN if x * y * z <= LARGE_FROM_VOXELS else LARGE_PLAN)


def plan_from(shape, iters: int, base) -> SweepPlan:
    """`sweep_plan`'s launches for one of SMALL_PLAN and LARGE_PLAN."""
    x, y, z = (int(v) for v in shape)
    k, tile_y, cols, seg = base
    n = -(-iters // k) if iters > 0 else 0
    sweeps = tuple(iters // n + (i < iters % n) for i in range(n)) if n else ()
    k = max(sweeps, default=1)
    return SweepPlan(sweeps, min(tile_y, y), min(cols, 32 * -(-(z + 2 * k) // 32)), min(seg, x))


def class_steps(voxel_size: float) -> np.ndarray:
    """The face, edge and corner steps (|off| = 1, sqrt 2, sqrt 3), each the
    one value `step_lengths` gives every offset of its class."""
    steps = step_lengths(voxel_size)
    cls = np.abs(OFFSETS).sum(axis=1) - 1
    out = np.array([steps[cls == c][0] for c in range(3)], np.float32)
    assert (steps == out[cls]).all()
    return out


def _check(sdf, weight):
    if sdf.dim() != 3 or sdf.dtype != torch.float32 or weight.dtype != torch.float32:
        raise ValueError("sdf and weight must be float32 [X, Y, Z] tensors")
    if weight.shape != sdf.shape or weight.device != sdf.device:
        raise ValueError(f"weight {tuple(weight.shape)} on {weight.device} does not match sdf "
                         f"{tuple(sdf.shape)} on {sdf.device}")
    if not (sdf.is_contiguous() and weight.is_contiguous()):
        raise ValueError("sdf and weight must be contiguous")


def _run_plan(sdf, weight, voxel_size: float, plan: SweepPlan):
    """The plan's launches in one call of the source's entry, each reading
    the previous one's output; every launch counted in
    `build.LAUNCHES["correct_sdf_dense"]`."""
    _check(sdf, weight)
    steps = class_steps(voxel_size)
    if not (steps >= 0).all():
        raise ValueError(f"the kernel takes a voxel size >= 0, not {voxel_size}")
    fn = build.load("correct_sdf_dense").i3d_correct_sdf_dense
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    steps = (ctypes.c_float * 3)(*steps.tolist())
    n = len(plan.sweeps)
    out = (torch.empty_like(sdf), torch.empty_like(weight))
    tmp = (torch.empty_like(sdf), torch.empty_like(weight)) if n > 1 else out
    with torch.cuda.device(sdf.device):
        rc = fn(sdf.data_ptr(), weight.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), tmp[0].data_ptr(),
                tmp[1].data_ptr(), *sdf.shape, n, (ctypes.c_int * n)(*plan.sweeps), plan.tile_y, plan.cols,
                plan.seg, steps, torch.cuda.current_stream(sdf.device).cuda_stream)
    if rc != 0:  # 1, cudaErrorInvalidValue: a launch of the plan exceeds the kernel's limits
        raise RuntimeError(f"correct_sdf_dense kernel launch failed for {plan}: CUDA error {rc}")
    build.LAUNCHES["correct_sdf_dense"] += n
    return out


def correct_sdf_dense(sdf, weight, voxel_size: float, iters: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distance-transform correction of a dense window: new (sdf, weight),
    the inputs left as they are. On a CUDA tensor, the launches of
    `sweep_plan(sdf.shape, iters)` (each counted in
    `build.LAUNCHES["correct_sdf_dense"]`); on a CPU tensor, the plain
    version."""
    if iters <= 0:
        return sdf.clone(), weight.clone()
    if sdf.is_cuda:
        return _run_plan(sdf, weight, voxel_size, sweep_plan(sdf.shape, iters))
    return correct_sdf_dense_plain(sdf, weight, voxel_size, iters)
