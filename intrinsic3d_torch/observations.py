"""Voxel ↔ keyframe observation weights (dense all-frames batch).

Counterpart of `intrinsic3d_tpu/observations.py::observation_weight` and the
dense (2-D `iso_pts`) case of `compute_observations_batch` (reference
``colorization.cpp:192-315``): for every (keyframe, voxel) pair, transform
the iso-surface point into the frame, project it through the distorted
camera, probe the frame's depth at the nearest pixel (`ops.bicubic.nearest_rows`,
the CUDA kernel on the card), test visibility against the occlusion distance
and score the observation with the grazing-angle robust weight.
"""

from __future__ import annotations

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
    iso_pts: torch.Tensor,  # [D, 3]
    normals: torch.Tensor,  # [D, 3]
    occlusion_distance,
    active=None,  # [K, D] float, 0 ⇒ weight not needed (not probed)
) -> torch.Tensor:
    """All-frames observation weights `[K, D]` — `compute_observation`
    batched over keyframes, with the depth probe through `nearest_rows`."""
    k = poses.shape[0]
    d = iso_pts.shape[0]
    pose_k = poses.view(k, 1, 6)
    pt = transform_points(pose_k, iso_pts.unsqueeze(0))  # [K, D, 3]
    rot_only = torch.cat([poses[:, :3], torch.zeros_like(poses[:, 3:])], dim=-1).view(k, 1, 6)
    n_cam = transform_points(rot_only, normals.unsqueeze(0))
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
