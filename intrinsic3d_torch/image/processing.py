"""RGB-D image processing: vertex maps, normals, depth resampling, erosion.

Counterpart of `intrinsic3d_tpu/image/processing.py` (reference
``libintrinsic3d/src/rgbd/processing.cpp:40-235``). Every function takes
images with any number of leading frame axes (`[..., H, W]`), so a stack of
frames is one call; the JAX package vmaps the single-frame form instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from intrinsic3d_torch.camera import Camera
from intrinsic3d_torch.image.interp import bilinear


def threshold_depth(depth, depth_min, depth_max):
    """Zero out depth outside [min, max] (``sensor.cpp:211-220``)."""
    return torch.where((depth >= depth_min) & (depth <= depth_max), depth, torch.zeros_like(depth))


def _pixel_grid(depth: torch.Tensor, cam: Camera):
    """Normalized pixel coordinates `(x0 [1, W], y0 [H, 1])` of `cam`."""
    h, w = depth.shape[-2], depth.shape[-1]
    xs = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    ys = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    return (xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy


def compute_vertex_map(cam: Camera, depth: torch.Tensor) -> torch.Tensor:
    """Back-project depth `[..., H, W]` to camera-frame points `[..., H, W, 3]`
    (``processing.cpp:49-71``)."""
    x0, y0 = _pixel_grid(depth, cam)
    return torch.stack([x0 * depth, y0 * depth, depth], dim=-1)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def compute_normals_from_vertex_map(vertex_map: torch.Tensor, depth_threshold=0.3) -> torch.Tensor:
    """Central-difference cross-product normals with depth-discontinuity
    gating (``processing.cpp:74-126``); zero where invalid and on the image
    border. `vertex_map` is `[..., H, W, 3]`."""
    v = vertex_map
    vx0 = torch.roll(v, 1, dims=-2)  # x-1
    vx1 = torch.roll(v, -1, dims=-2)  # x+1
    vy0 = torch.roll(v, 1, dims=-3)  # y-1
    vy1 = torch.roll(v, -1, dims=-3)  # y+1
    tx = vx1 - vx0
    ty = vy1 - vy0
    # n = ty × tx
    n = torch.stack(
        [
            ty[..., 1] * tx[..., 2] - ty[..., 2] * tx[..., 1],
            ty[..., 2] * tx[..., 0] - ty[..., 0] * tx[..., 2],
            ty[..., 0] * tx[..., 1] - ty[..., 1] * tx[..., 0],
        ],
        dim=-1,
    )
    norm = _norm3(n)[..., None]
    n = n / torch.where(norm == 0.0, torch.full_like(norm, 1e-12), norm)

    valid = (
        (v[..., 2] != 0.0)
        & (vx0[..., 2] != 0.0)
        & (vx1[..., 2] != 0.0)
        & (vy0[..., 2] != 0.0)
        & (vy1[..., 2] != 0.0)
        & (_norm3(tx) < depth_threshold)
        & (_norm3(ty) < depth_threshold)
    )
    # border pixels are invalid (the reference loops y, x over [1, dim-2])
    h, w = v.shape[-3], v.shape[-2]
    border = torch.zeros((h, w), dtype=torch.bool, device=v.device)
    border[1:-1, 1:-1] = True
    valid = valid & border
    return torch.where(valid[..., None], n, torch.zeros_like(n))


def compute_normals(cam: Camera, depth: torch.Tensor, depth_threshold=0.3) -> torch.Tensor:
    return compute_normals_from_vertex_map(compute_vertex_map(cam, depth), depth_threshold)


def resize_depth(input_cam: Camera, depth: torch.Tensor, output_cam: Camera) -> torch.Tensor:
    """Reproject depth `[..., H, W]` from the depth camera into the color
    camera's pixel grid (``processing.cpp:129-181``) by bilinear lookup along
    each output pixel's ray; zero stays zero, and an output pixel whose
    rounded source pixel lies outside the input is zero. The result is
    contiguous, as the card's samplers take their depth stacks."""
    if tuple(depth.shape[-2:]) == (output_cam.height, output_cam.width):
        return depth
    h, w = output_cam.height, output_cam.width
    probe = depth.new_empty((h, w))
    x0, y0 = _pixel_grid(probe, output_cam)
    px = (input_cam.fx * x0 + input_cam.cx).expand(h, w)
    py = (input_cam.fy * y0 + input_cam.cy).expand(h, w)
    pxi = torch.floor(px + 0.5)
    pyi = torch.floor(py + 0.5)
    inside = (pxi >= 0) & (pyi >= 0) & (pxi < depth.shape[-1]) & (pyi < depth.shape[-2])
    lead = depth.shape[:-2]
    frames = depth.reshape(-1, depth.shape[-2], depth.shape[-1]).permute(1, 2, 0)  # [H, W, F]
    d = torch.where(inside[..., None], bilinear(frames, px, py), 0.0)  # [h, w, F]
    return d.permute(2, 0, 1).reshape(*lead, h, w).contiguous()


def erode_discontinuities(depth: torch.Tensor, window_size=2, max_depth_diff=0.5) -> torch.Tensor:
    """Invalidate pixels whose (2k+1)² window holds a zero or a depth jump
    larger than `max_depth_diff` (``processing.cpp:184-235``). The reference
    skips out-of-image taps; replicate padding inspects a border value again,
    which gives the same result for both tests."""
    if window_size <= 0:
        return depth
    k = window_size
    h, w = depth.shape[-2], depth.shape[-1]
    pad = F.pad(depth.reshape(-1, 1, h, w), (k, k, k, k), mode="replicate").reshape(
        *depth.shape[:-2], h + 2 * k, w + 2 * k
    )
    ok = depth != 0.0
    for dy in range(-k, k + 1):
        for dx in range(-k, k + 1):
            dn = pad[..., k + dy : k + dy + h, k + dx : k + dx + w]
            ok = ok & (dn != 0.0) & (torch.abs(dn - depth) <= max_depth_diff)
    return torch.where(ok, depth, torch.zeros_like(depth))
