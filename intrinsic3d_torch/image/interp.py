"""Image sampling (counterpart of `intrinsic3d_tpu/image/interp.py`):
boundary-aware bilinear (reference ``processing.cpp:238-301``) and
clamped-boundary Catmull-Rom bicubic (``cost.h:108-127``).

Images are `[H, W]` or `[H, W, C]`; sample coordinates `(x, y)` are pixel
coordinates with integer values on pixel centres.
"""

from __future__ import annotations

import torch

from intrinsic3d_torch.ops.bicubic import _catrom_w


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Out-of-bounds taps get zero weight; the result is renormalized by the
    sum of valid weights (zero when no tap is valid)."""
    h, w = img.shape[0], img.shape[1]
    chan = img.dim() == 3
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = x0 + 1
    y1 = y0 + 1
    wx1 = x - x0.to(x.dtype)
    wy1 = y - y0.to(y.dtype)
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    zero = torch.zeros_like(wx0)
    wx0 = torch.where((x0 >= 0) & (x0 < w), wx0, zero)
    wx1 = torch.where((x1 >= 0) & (x1 < w), wx1, zero)
    wy0 = torch.where((y0 >= 0) & (y0 < h), wy0, zero)
    wy1 = torch.where((y1 >= 0) & (y1 < h), wy1, zero)
    x0c = torch.clamp(x0, 0, w - 1)
    x1c = torch.clamp(x1, 0, w - 1)
    y0c = torch.clamp(y0, 0, h - 1)
    y1c = torch.clamp(y1, 0, h - 1)

    w00 = wx0 * wy0
    w10 = wx1 * wy0
    w01 = wx0 * wy1
    w11 = wx1 * wy1
    wsum = w00 + w10 + w01 + w11

    def cw(wt):
        return wt[..., None] if chan else wt

    acc = (
        img[y0c, x0c] * cw(w00)
        + img[y0c, x1c] * cw(w10)
        + img[y1c, x0c] * cw(w01)
        + img[y1c, x1c] * cw(w11)
    )
    wsafe = torch.where(wsum > 0.0, wsum, torch.ones_like(wsum))
    out = acc / cw(wsafe)
    return torch.where(cw(wsum > 0.0), out, torch.zeros_like(out))


def bicubic(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Clamped-boundary Catmull-Rom sampling of `img [H, W]` at (x, y), the
    behaviour of ceres::BiCubicInterpolator over Grid2D; C¹ and
    differentiable in x and y. (The refinement samples its images through
    `ops.bicubic.bicubic_rows` instead.)"""
    h, w = img.shape[0], img.shape[1]
    x, y = torch.broadcast_tensors(x, y)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wxs = _catrom_w(x - x0)
    wys = _catrom_w(y - y0)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    acc = torch.zeros_like(x, dtype=img.dtype)
    for j, wy in enumerate(wys):
        yi = torch.clamp(y0i + (j - 1), 0, h - 1)
        row = torch.zeros_like(acc)
        for i, wx in enumerate(wxs):
            row = row + img[yi, torch.clamp(x0i + (i - 1), 0, w - 1)] * wx
        acc = acc + row * wy
    return acc
