"""TSDF fusion: allocation and projective integration on the device.

Counterpart of `intrinsic3d_tpu/grid/fusion.py` (reference
``SparseVoxelGrid::integrate``/``alloc``, ``sparse_voxel_grid.cpp:300-467``):

1. Allocation is a set union, kept as a dense occupancy bitmap over the
   scene's voxel AABB on the device: every depth ray is sampled at ±truncation
   around its measured depth, the samples' voxels are set, and the bitmap is
   dilated by a 3³ OR (the reference's per-voxel block dilation,
   ``sparse_voxel_grid.cpp:449-462``).
2. Integration is a weighted mean over all (voxel, frame) contributions,
   so each frame adds into four accumulators on the device; `finalize`
   divides on the host, as the JAX package does.

The scene bounds are float64 numpy, copied verbatim. The JAX package's
TPU-shaped parts are not carried over: its NaN-padded ray-step chunks, scans
over frame stacks with donated buffers, and the `mesh=` sharding of the
integration (which waits for the port's multi-card work).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from intrinsic3d_torch.camera import Camera
from intrinsic3d_torch.device import resolve_device
from intrinsic3d_torch.grid.voxel_grid import VoxelGrid
from intrinsic3d_torch.image.processing import compute_normals
from intrinsic3d_torch.mathutil import robust_kernel

# ray samples per allocation chunk: bounds the chunk's temporaries at
# ~16M samples (a 640×480 frame's 41 steps are one chunk)
_ALLOC_CHUNK_SAMPLES = 1 << 24


# ---------------------------------------------------------------------------
# Scene bounds
# ---------------------------------------------------------------------------


def frustum_corners(cam: Camera, depth_min: float, depth_max: float) -> np.ndarray:
    """8 camera-frame frustum corner points (``math.cpp:131-148``)."""
    corners = []
    for d in (depth_min, depth_max):
        for x, y in ((0, 0), (cam.width - 1, 0), (cam.width - 1, cam.height - 1), (0, cam.height - 1)):
            px = (x - float(cam.cx)) / float(cam.fx)
            py = (y - float(cam.cy)) / float(cam.fy)
            corners.append((px * d, py * d, d))
    return np.array(corners, dtype=np.float64)


def compute_scene_voxel_bounds(
    cam: Camera,
    poses_cam_to_world: Iterable[np.ndarray],
    depth_min: float,
    depth_max: float,
    voxel_size: float,
    clip_bounds: Optional[Tuple[float, ...]] = None,
    truncation: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Voxel-coordinate AABB (lo, hi inclusive) covering all frame frustums
    (intersected with clip bounds when given)."""
    trunc = truncation if truncation is not None else voxel_size * 5.0
    corners = frustum_corners(cam, depth_min, depth_max)
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    for T in poses_cam_to_world:
        w = corners @ np.asarray(T)[:3, :3].T + np.asarray(T)[:3, 3]
        lo = np.minimum(lo, w.min(axis=0))
        hi = np.maximum(hi, w.max(axis=0))
    lo -= trunc
    hi += trunc
    if clip_bounds is not None and any(abs(b) > 0 for b in clip_bounds):
        cb = np.asarray(clip_bounds, dtype=np.float64)
        lo = np.maximum(lo, cb[[0, 2, 4]])
        hi = np.minimum(hi, cb[[1, 3, 5]])
    vlo = np.floor(lo / voxel_size).astype(np.int64) - 1
    vhi = np.ceil(hi / voxel_size).astype(np.int64) + 1
    return vlo, vhi


def ray_offsets(truncation: float, num_steps: int) -> np.ndarray:
    """The float32 depth offsets of the allocation's ray samples, evenly
    spaced over [−truncation, truncation] by `jnp.linspace`'s formula
    (start·(1 − s) + stop·s with s = i/(n−1), the stop exact); XLA may round
    a sample one ulp apart."""
    start, stop = np.float32(-truncation), np.float32(truncation)
    if num_steps == 1:
        return np.array([start], np.float32)
    div = num_steps - 1
    s = np.arange(div, dtype=np.float32) / np.float32(div)
    return np.concatenate([start * (np.float32(1.0) - s) + stop * s, [stop]]).astype(np.float32)


def _dilate27(occ: torch.Tensor) -> torch.Tensor:
    """3³ morphological OR of a bool volume, as three separable 3-tap ORs."""
    out = occ
    for axis in range(3):
        n = out.shape[axis]
        grown = out.clone()
        grown.narrow(axis, 1, n - 1).logical_or_(out.narrow(axis, 0, n - 1))
        grown.narrow(axis, 0, n - 1).logical_or_(out.narrow(axis, 1, n - 1))
        out = grown
    return out


def _rigid(pts: torch.Tensor, rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """`pts @ rot.T + trans` in float32 (full-precision matmul on the card
    needs `torch.backends.cuda.matmul.allow_tf32 = False`, the default)."""
    return pts @ rot.T + trans


class FusionVolume:
    """Streaming TSDF fusion over a fixed scene AABB, on `device`.

    Usage: construct, `allocate[_batch]` every frame, then `build_grid()`,
    then `integrate[_batch]` every frame, then `finalize()`.
    """

    def __init__(
        self,
        depth_cam: Camera,
        color_cam: Camera,
        voxel_size: float,
        vlo: np.ndarray,
        vhi: np.ndarray,
        depth_min: float,
        depth_max: float,
        clip_bounds: Optional[Tuple[float, ...]] = None,
        integration_weight_sample: float = 10.0,
        alloc_step_factor: float = 0.25,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.depth_cam = depth_cam
        self.color_cam = color_cam
        self.voxel_size = float(voxel_size)
        self.truncation = self.voxel_size * 5.0
        self.depth_min = float(depth_min)
        self.depth_max = float(depth_max)
        self.weight_sample = float(integration_weight_sample)
        self.vlo = np.asarray(vlo, np.int64)
        self.dims = tuple(int(d) for d in (np.asarray(vhi) - self.vlo + 1))
        if np.prod(self.dims) > 1_500_000_000:
            raise MemoryError(f"scene AABB too large for occupancy bitmap: {self.dims}")
        self.clip = np.zeros(6, np.float32) if clip_bounds is None else np.asarray(clip_bounds, np.float32)
        step = self.voxel_size * alloc_step_factor
        self.num_steps = int(np.floor(2.0 * self.truncation / step)) + 1

        dev = self.device
        h, w = depth_cam.height, depth_cam.width
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        rays = np.stack(
            [(xs - float(depth_cam.cx)) / float(depth_cam.fx), (ys - float(depth_cam.cy)) / float(depth_cam.fy),
             np.ones_like(xs)],
            axis=-1,
        )
        self._rays = torch.as_tensor(rays, device=dev)
        self._offs = torch.as_tensor(ray_offsets(self.truncation, self.num_steps), device=dev)
        self._lo = torch.as_tensor(self.vlo, dtype=torch.int32, device=dev)
        self._clip = torch.as_tensor(self.clip, device=dev)
        # one slot past the volume takes every dropped sample
        self._occ = torch.zeros(int(np.prod(self.dims)) + 1, dtype=torch.bool, device=dev)
        self.grid: Optional[VoxelGrid] = None
        self._acc = None
        self._world_pts = None

    def _tensor(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray) and not a.flags.writeable:
            a = a.copy()  # torch refuses to wrap read-only memory
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # -- phase 1: allocation ----------------------------------------------

    def allocate(self, depth, pose_cam_to_world: np.ndarray) -> None:
        self.allocate_batch(self._tensor(depth)[None], np.asarray(pose_cam_to_world)[None])

    def allocate_batch(self, depths, poses: np.ndarray) -> None:
        """Allocation over a stack of frames (`[G, H, W]` depths, `[G, 4, 4]`
        camera-to-world poses): scatter each ray's samples into the bitmap
        (``sparse_voxel_grid.cpp:398-447``)."""
        depths = self._tensor(depths)
        T = np.asarray(poses, np.float64)
        rots, transs = self._tensor(T[:, :3, :3]), self._tensor(T[:, :3, 3])
        x, y, z = self.dims
        h, w = depths.shape[1:]
        chunk = max(1, _ALLOC_CHUNK_SAMPLES // (h * w))
        use_clip = bool(np.any(self.clip != 0.0))
        for depth, rot, trans in zip(depths, rots, transs):
            for c in range(0, self.num_steps, chunk):
                d = depth[None] + self._offs[c : c + chunk, None, None]  # [C, H, W]
                pts_w = _rigid(self._rays[None] * d[..., None], rot, trans)
                vox = torch.round(pts_w / self.voxel_size).to(torch.int32)
                idx = (vox - self._lo).to(torch.int64)
                valid = (depth[None] > 0.0) & torch.isfinite(d)
                valid &= (idx >= 0).all(dim=-1)
                valid &= (idx[..., 0] < x) & (idx[..., 1] < y) & (idx[..., 2] < z)
                if use_clip:
                    pw = vox.to(torch.float32) * self.voxel_size
                    cl = self._clip
                    valid &= (
                        (pw[..., 0] >= cl[0]) & (pw[..., 0] <= cl[1])
                        & (pw[..., 1] >= cl[2]) & (pw[..., 1] <= cl[3])
                        & (pw[..., 2] >= cl[4]) & (pw[..., 2] <= cl[5])
                    )
                flat = (idx[..., 0] * y + idx[..., 1]) * z + idx[..., 2]
                flat = torch.where(valid, flat, torch.full_like(flat, x * y * z))
                self._occ[flat.reshape(-1)] = True

    def build_grid(self) -> VoxelGrid:
        """Dilate the bitmap, list its voxels into the host grid, and zero
        the device accumulators."""
        occ = _dilate27(self._occ[:-1].view(self.dims))
        coords = torch.nonzero(occ).cpu().numpy().astype(np.int64) + self.vlo
        self._occ = None
        self.grid = VoxelGrid.from_coords(self.voxel_size, coords, self.depth_min, self.depth_max)
        self.grid.integration_weight_sample = self.weight_sample
        n = self.grid.num_voxels
        dev = self.device
        self._world_pts = torch.as_tensor(self.grid.voxel_to_world(), device=dev)
        self._acc = (
            torch.zeros(n, device=dev),  # Σ w·sdf
            torch.zeros(n, device=dev),  # Σ w
            torch.zeros((n, 3), device=dev),  # Σ w·color (0..255)
            torch.zeros(n, device=dev),  # Σ w (color-valid)
        )
        return self.grid

    # -- phase 2: integration ---------------------------------------------

    def integrate(self, depth, normals, color, pose_cam_to_world: np.ndarray) -> None:
        """Accumulate one frame. `depth` should already be eroded; `color` is
        RGB float [0, 1] at the color camera's resolution."""
        Tinv = np.linalg.inv(np.asarray(pose_cam_to_world, np.float64))
        self._integrate_frame(
            self._tensor(depth), self._tensor(normals), self._tensor(color),
            self._tensor(Tinv[:3, :3]), self._tensor(Tinv[:3, 3]),
        )

    def integrate_batch(self, depths, colors, poses: np.ndarray) -> None:
        """Integration over a stack of frames, with the cross-product surface
        normals (``processing.cpp:74-126``) of all frames in one call."""
        depths, colors = self._tensor(depths), self._tensor(colors)
        normals = compute_normals(self.depth_cam, depths)
        Tinv = np.linalg.inv(np.asarray(poses, np.float64))
        rots, ts = self._tensor(Tinv[:, :3, :3]), self._tensor(Tinv[:, :3, 3])
        for g in range(depths.shape[0]):
            self._integrate_frame(depths[g], normals[g], colors[g], rots[g], ts[g])

    def _integrate_frame(self, depth, normals, color, rot_w2c, t_w2c) -> None:
        """Per-voxel projective TSDF update for one frame
        (``sparse_voxel_grid.cpp:315-391``)."""
        wsdf_acc, w_acc, wc_acc, cw_acc = self._acc
        dcam, ccam, trunc, ws = self.depth_cam, self.color_cam, self.truncation, self.weight_sample
        h, w = depth.shape
        p = _rigid(self._world_pts, rot_w2c, t_w2c)  # [N, 3] camera frame
        z = p[:, 2]
        valid = z > 0.0

        # nearest-pixel depth lookup (the reference rounds project2)
        zs = torch.where(z == 0.0, torch.full_like(z, 1e-12), z)
        ui = torch.floor(p[:, 0] * dcam.fx / zs + dcam.cx + 0.5).to(torch.int64)
        vi = torch.floor(p[:, 1] * dcam.fy / zs + dcam.cy + 0.5).to(torch.int64)
        valid &= (ui >= 0) & (vi >= 0) & (ui < w) & (vi < h)
        uic = torch.clamp(ui, 0, w - 1)
        vic = torch.clamp(vi, 0, h - 1)
        d = depth[vic, uic]
        valid &= d > 0.0

        sdf = d - z
        valid &= sdf > -trunc
        tsdf = torch.clamp(sdf, -trunc, trunc)

        # three-term integration weight (``sparse_voxel_grid.cpp:344-369``)
        n = normals[vic, uic]
        pn = torch.sqrt(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2])
        p_norm = p / torch.clamp(pn, min=1e-12)[:, None]
        cos = p_norm[:, 0] * n[:, 0] + p_norm[:, 1] * n[:, 1] + p_norm[:, 2] * n[:, 2]
        w_normal = torch.clamp(1.0 - torch.abs(cos), 0.0, 1.0)
        w_normal = torch.clamp(ws * robust_kernel(w_normal), min=1.0)
        w_dist = torch.clamp(ws * robust_kernel(2.0 * torch.abs(tsdf) / trunc), min=1.0)
        # the depth span as float32 arithmetic forms it
        span = float(np.float32(self.depth_max) - np.float32(self.depth_min))
        w_depth = torch.clamp(ws * (1.0 - (d - self.depth_min) / span), min=1.0)
        weight_update = torch.clamp((w_normal + w_dist + w_depth) / 3.0, min=3.0)
        if not ws > 0.0:
            weight_update = torch.ones_like(weight_update)

        zero = torch.zeros_like(weight_update)
        wu = torch.where(valid, weight_update, zero)
        wsdf_acc += wu * sdf
        w_acc += wu

        # color from the (differently sized) color camera (``:376-387``)
        hc, wc = color.shape[0], color.shape[1]
        uci = torch.floor(p[:, 0] * ccam.fx / zs + ccam.cx + 0.5).to(torch.int64)
        vci = torch.floor(p[:, 1] * ccam.fy / zs + ccam.cy + 0.5).to(torch.int64)
        cval = valid & (uci >= 0) & (vci >= 0) & (uci < wc) & (vci < hc)
        c = color[torch.clamp(vci, 0, hc - 1), torch.clamp(uci, 0, wc - 1)] * 255.0
        cwu = torch.where(cval, weight_update, zero)
        wc_acc += cwu[:, None] * c
        cw_acc += cwu

    def finalize(self) -> VoxelGrid:
        """Weighted means into the host grid: sdf and weight, color in
        [0, 255]; unseen voxels keep sdf 0 and weight 0."""
        wsdf, w, wc, cw = (a.cpu().numpy() for a in self._acc)
        g = self.grid
        seen = w > 0.0
        g.sdf = np.where(seen, wsdf / np.maximum(w, np.float32(1e-12)), 0.0).astype(np.float32)
        g.weight = w.astype(np.float32)
        cseen = cw > 0.0
        g.color = np.where(cseen[:, None], wc / np.maximum(cw, np.float32(1e-12))[:, None], 0.0).astype(np.float32)
        return g
