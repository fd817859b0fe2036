"""Voxel ↔ keyframe observations: weights, best-N selection, recoloring.

Counterpart of `intrinsic3d_tpu/observations.py` (reference
``colorization.cpp:162-370``): for every (keyframe, voxel) pair, transform
the iso-surface point into the frame, project it through the distorted
camera, probe the frame's depth at the nearest pixel, test visibility
against the occlusion distance and score the observation with the
grazing-angle robust weight. `compute_observations_batch` is the device
assembly's form, its depth probe the CUDA kernel `ops.bicubic.nearest_rows`
on the card; `collect_observations` and `recolor` are the recolor sweep's,
whose probe is a plain gather, as in the JAX package. The flat-table
assembly takes `best_observations` of `compute_observations_batch`'s
weights: the same weights, probed through the kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from intrinsic3d_torch.camera import Camera, project
from intrinsic3d_torch.mathutil import robust_kernel, transform_points
from intrinsic3d_torch.ops.bicubic import nearest_rows


def observation_weight(pt_cam, normal_cam, d):
    """Grazing-angle × depth observation weight (``colorization.cpp:274-315``).

    The reference's depth term degenerates to the constant 1 (it is
    `clamp(max(1 − d_norm, 1.0), 0.001, 5)`), reproduced faithfully."""
    n_zero = torch.all(normal_cam == 0.0, dim=-1)
    v = pt_cam / torch.clamp(torch.linalg.vector_norm(pt_cam, dim=-1, keepdim=True), min=1e-12)
    w_normal = 1.0 - torch.abs(torch.sum(v * normal_cam, dim=-1))
    w_normal = torch.clamp(w_normal, 0.0, 1.0)
    w_normal = torch.clamp(robust_kernel(w_normal), min=0.001)
    w_normal = torch.where(n_zero, torch.zeros_like(w_normal), w_normal)
    d_norm = (torch.clamp(d, 0.01, 5.0) - 0.01) / (5.0 - 0.01)
    w_depth = torch.clamp(torch.clamp(1.0 - d_norm, min=1.0), 0.001, 5.0)
    return w_normal * w_depth


def compute_observations_batch(
    cam: Camera,
    poses: torch.Tensor,  # [K, 6]
    depths: torch.Tensor,  # [K, H, W]
    iso_pts: torch.Tensor,  # [D, 3] shared, or [K, E, 3] per frame row (frame-bucketed elements)
    normals: torch.Tensor,  # [D, 3] or [K, E, 3], matching iso_pts
    occlusion_distance,
    active=None,  # [K, D] float, 0 ⇒ weight not needed (not probed)
) -> torch.Tensor:
    """All-frames observation weights `[K, D]` — `compute_observation`
    batched over keyframes, with the depth probe through `nearest_rows`.
    3-D `iso_pts`/`normals` give each keyframe row its own points (row k of
    the frame-bucketed layout holds the slots of frame k's visible
    blocks)."""
    k = poses.shape[0]
    d = iso_pts.shape[-2]
    if iso_pts.dim() == 2:
        iso_pts, normals = iso_pts.unsqueeze(0), normals.unsqueeze(0)
    pose_k = poses.view(k, 1, 6)
    pt = transform_points(pose_k, iso_pts)  # [K, D, 3]
    rot_only = torch.cat([poses[:, :3], torch.zeros_like(poses[:, 3:])], dim=-1).view(k, 1, 6)
    n_cam = transform_points(rot_only, normals)
    uv, valid = project(cam, pt)
    ui = torch.floor(uv[..., 0] + 0.5).to(torch.int32)
    vi = torch.floor(uv[..., 1] + 0.5).to(torch.int32)
    uic = torch.clamp(ui, 0, cam.width - 1)
    vic = torch.clamp(vi, 0, cam.height - 1)

    act = torch.ones((k, d), dtype=torch.float32, device=poses.device) if active is None else active
    fid = torch.arange(k, dtype=torch.int32, device=poses.device).view(k, 1).expand(k, d)
    depth = nearest_rows(
        depths,
        fid.reshape(-1).contiguous(),
        vic.reshape(-1).contiguous(),
        uic.reshape(-1).contiguous(),
        act.reshape(-1).to(torch.float32).contiguous(),
    ).reshape(k, d)

    z = pt[..., 2]
    if float(occlusion_distance) > 0.0:
        visible = (depth > 0.0) & (torch.abs(depth - z) <= occlusion_distance)
    else:
        visible = torch.ones_like(valid)
    w = observation_weight(pt, n_cam, depth)
    keep = valid & visible & (depth > 0.0) & (act > 0.0)
    return torch.where(keep, w, torch.zeros_like(w))


def _rot_only(poses: torch.Tensor) -> torch.Tensor:
    """Poses `[..., 6]` with the translation zeroed (rotate normals only)."""
    return torch.cat([poses[..., :3], torch.zeros_like(poses[..., 3:])], dim=-1)


def compute_observation(
    cam: Camera,
    poses: torch.Tensor,  # [K, 6] world→cam angle-axis + t
    depths: torch.Tensor,  # [K, H, W]
    iso_pts: torch.Tensor,  # [M, 3] world-space iso-surface points
    normals: torch.Tensor,  # [M, 3] world-space voxel normals
    occlusion_distance: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weights of K frames' observations of M voxels
    (``colorization.cpp:215-315``), the JAX function batched over frames.
    The depth probe is a plain gather at the nearest pixel (clamped into the
    image). Returns (weight `[K, M]`, uv `[K, M, 2]`)."""
    k = poses.shape[0]
    pt = transform_points(poses.view(k, 1, 6), iso_pts.unsqueeze(0))  # [K, M, 3]
    uv, valid = project(cam, pt)
    uic = torch.clamp(torch.floor(uv[..., 0] + 0.5).to(torch.int64), 0, cam.width - 1)
    vic = torch.clamp(torch.floor(uv[..., 1] + 0.5).to(torch.int64), 0, cam.height - 1)
    fid = torch.arange(k, device=poses.device).view(k, 1)
    d = depths[fid, vic, uic]
    # visibility: |d − z| ≤ occlusion_distance (``colorization.cpp:252-270``)
    if float(occlusion_distance) > 0.0:
        visible = (d > 0.0) & (torch.abs(d - pt[..., 2]) <= occlusion_distance)
    else:
        visible = torch.ones_like(valid)
    n_cam = transform_points(_rot_only(poses).view(k, 1, 6), normals.unsqueeze(0))
    w = observation_weight(pt, n_cam, d)
    return torch.where(valid & visible & (d > 0.0), w, torch.zeros_like(w)), uv


def collect_observations(
    cam: Camera,
    poses: torch.Tensor,  # [K, 6] world→cam
    depths: torch.Tensor,  # [K, H, W]
    iso_pts: torch.Tensor,  # [N, 3]
    normals: torch.Tensor,  # [N, 3]
    occlusion_distance: float,
    num_best: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-`num_best` observations per voxel over all K frames
    (``colorization.cpp:357-370``): `best_observations` of
    `compute_observation`'s weights."""
    weights, _ = compute_observation(cam, poses, depths, iso_pts, normals, occlusion_distance)
    return best_observations(weights, num_best)


def best_observations(weights: torch.Tensor, num_best: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `num_best` largest of each voxel's frame weights `[K, N]`; ties
    keep the lower frame index first (`lax.top_k`'s order), by a stable
    descending sort. Returns (obs_weight `[N, num_best]`, obs_frame
    `[N, num_best]` int32); weight 0 marks an empty slot, whose frame id is
    arbitrary."""
    k = min(num_best, weights.shape[0])
    order = torch.argsort(-weights.T, dim=1, stable=True)[:, :k]  # [N, k]
    return torch.gather(weights.T, 1, order), order.to(torch.int32)


def bilinear_frames(images: torch.Tensor, frame_ids: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling where each query reads its own frame: `images [K,
    H, W(, C)]`, `frame_ids [N]`, `x, y [N]`. Out-of-image taps get weight 0
    and the rest are renormalized; no valid tap gives 0."""
    h, w = images.shape[1], images.shape[2]
    chan = images.dim() == 4
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1, y1 = x0 + 1, y0 + 1
    wx1 = x - x0.to(x.dtype)
    wy1 = y - y0.to(y.dtype)
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    zero = torch.zeros_like(wx0)
    wx0 = torch.where((x0 >= 0) & (x0 < w), wx0, zero)
    wx1 = torch.where((x1 >= 0) & (x1 < w), wx1, zero)
    wy0 = torch.where((y0 >= 0) & (y0 < h), wy0, zero)
    wy1 = torch.where((y1 >= 0) & (y1 < h), wy1, zero)
    x0c, x1c = torch.clamp(x0, 0, w - 1), torch.clamp(x1, 0, w - 1)
    y0c, y1c = torch.clamp(y0, 0, h - 1), torch.clamp(y1, 0, h - 1)
    fid = frame_ids.to(torch.int64)

    def tap(yc, xc):
        return images[fid, yc, xc].to(torch.float32)

    w00, w10, w01, w11 = wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1
    if chan:
        w00, w10, w01, w11 = (z.unsqueeze(-1) for z in (w00, w10, w01, w11))
    acc = tap(y0c, x0c) * w00 + tap(y0c, x1c) * w10 + tap(y1c, x0c) * w01 + tap(y1c, x1c) * w11
    wsum = w00 + w10 + w01 + w11
    has = wsum > 0.0
    return torch.where(has, acc / torch.where(has, wsum, torch.ones_like(wsum)), torch.zeros_like(acc))


def recolor(
    cam: Camera,
    poses: torch.Tensor,  # [K, 6]
    colors: torch.Tensor,  # [K, H, W, 3] uint8 or float 0..255
    iso_pts: torch.Tensor,  # [N, 3]
    obs_weight: torch.Tensor,  # [N, B]
    obs_frame: torch.Tensor,  # [N, B]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted-mean voxel colors from the selected observations
    (``colorization.cpp:162-189, 320-370``), slots summed in order. Returns
    (colors `[N, 3]` in 0..255, has `[N]`); a voxel without weight gets 0.
    (The JAX function also takes the depths, normals and occlusion distance,
    which it does not read.)"""
    n, bmax = obs_weight.shape
    acc = torch.zeros((n, 3), dtype=torch.float32, device=obs_weight.device)
    for b in range(bmax):
        f = obs_frame[:, b].to(torch.int64)
        uv, _ = project(cam, transform_points(poses[f], iso_pts))
        acc = acc + bilinear_frames(colors, f, uv[:, 0], uv[:, 1]) * obs_weight[:, b].unsqueeze(-1)
    wsum = torch.sum(obs_weight, dim=-1)
    has = wsum > 0.0
    out = acc / torch.clamp(wsum, min=1e-12).unsqueeze(-1)
    return torch.where(has.unsqueeze(-1), out, torch.zeros_like(out)), has
