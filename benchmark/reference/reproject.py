"""Depth reprojected from the depth camera to a registered colour camera
(the upstream's `resizeDepth`, processing.cpp:129-181, called for every
keyframe by `Intrinsic3D::init`, intrinsic3d.cpp:151-203): each colour
pixel's ray at unit depth projected into the depth image, its depth the
bilinear lookup there; a colour pixel whose rounded source pixel lies
outside the depth image reads 0, and one whose four taps are all 0 stays 0.

Departures from the upstream, none of which changes a value beyond the
dtype's rounding:
- the whole stack of frames in one call, in `dtype`, where the upstream
  loops pixels in float32;
- the two cameras' pinholes only (no distortion), as the upstream's
  `unproject2`/`project2` pair reads them;
- a tap outside the depth image weighs 0 and the others are renormalized,
  as the upstream's `interpolate` (processing.cpp:238-301) skips it; a 0
  tap inside the image is averaged in as a 0, so a colour pixel on the
  object's silhouette reads a blend of the object's depth and 0, as there.
"""

from __future__ import annotations

import torch


def resize_depth(depths, depth_cam: dict, color_cam: dict, dtype=torch.float64):
    """Depth maps `depths [F, Hd, Wd]` (metres, 0 = none) of the camera
    `depth_cam` reprojected to `color_cam` (dicts of fx, fy, cx, cy, width,
    height), computed in `dtype`: `[F, Hc, Wc]`."""
    dev = depths.device
    d = depths.to(dtype)
    hd, wd = d.shape[-2:]
    hc, wc = int(color_cam["height"]), int(color_cam["width"])
    # the colour pixel's ray at depth 1, projected into the depth image:
    # separable, x from the column, y from the row
    xr = (torch.arange(wc, device=dev).to(dtype) - color_cam["cx"]) / color_cam["fx"]
    yr = (torch.arange(hc, device=dev).to(dtype) - color_cam["cy"]) / color_cam["fy"]
    px = depth_cam["fx"] * xr + depth_cam["cx"]  # [Wc]
    py = depth_cam["fy"] * yr + depth_cam["cy"]  # [Hc]
    xi, yi = torch.floor(px + 0.5), torch.floor(py + 0.5)
    inside = ((yi >= 0) & (yi < hd))[:, None] & ((xi >= 0) & (xi < wd))[None, :]

    x0, y0 = torch.floor(px).long(), torch.floor(py).long()
    wx = [1.0 - (px - x0.to(dtype)), px - x0.to(dtype)]
    wy = [1.0 - (py - y0.to(dtype)), py - y0.to(dtype)]
    xs, ys = [x0, x0 + 1], [y0, y0 + 1]
    acc = torch.zeros((d.shape[0], hc, wc), dtype=dtype, device=dev)
    wsum = torch.zeros((hc, wc), dtype=dtype, device=dev)
    for j in range(2):
        oky = (ys[j] >= 0) & (ys[j] < hd)
        wj = torch.where(oky, wy[j], torch.zeros_like(wy[j]))
        rows = d[:, ys[j].clamp(0, hd - 1), :]  # [F, Hc, Wd]
        for i in range(2):
            okx = (xs[i] >= 0) & (xs[i] < wd)
            wi = torch.where(okx, wx[i], torch.zeros_like(wx[i]))
            w = wj[:, None] * wi[None, :]  # [Hc, Wc]
            acc = acc + rows[:, :, xs[i].clamp(0, wd - 1)] * w
            wsum = wsum + w
    out = acc / torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    return torch.where((inside & (wsum > 0))[None], out, torch.zeros_like(out))


def reproject_gap(port, ref) -> float:
    """The 99th percentile, over the pixels valid (> 0) in either stack, of
    |port − ref| / ref; a pixel valid in one stack and not the other counts
    1, a full gap."""
    from benchmark.reference.common import quantile

    p = torch.as_tensor(port, device=ref.device).to(torch.float64)
    r = ref.to(torch.float64)
    either = (p > 0) | (r > 0)
    both = (p > 0) & (r > 0)
    gap = torch.where(both, torch.abs(p - r) / torch.where(both, r, torch.ones_like(r)), torch.ones_like(r))
    return quantile(gap[either], 0.99)
