"""Per-keyframe image pyramids: the color and depth downsampling steps.

Counterpart of `intrinsic3d_tpu/image/pyramid.py` (reference
``libintrinsic3d/src/rgbd/pyramid.cpp``): color levels use cv::pyrDown's
[1 4 6 4 1]/16 separable filter with REFLECT_101 borders, then keep the even
rows and columns; depth levels are a zero-aware 2×2 mean
(``pyramid.cpp:116-141``). Both take a stack of frames (`[K, H, W]`, or
`[K, H, W, C]` for color) and filter along the two image axes; the JAX
package vmaps the single-frame form instead.
"""

from __future__ import annotations

import torch

_KERNEL5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source index of each of the `n + 2·pad` padded positions, mirrored
    about the edge pixels (numpy's `mode="reflect"`, OpenCV's REFLECT_101)."""
    i = torch.arange(-pad, n + pad, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def _filter5(img: torch.Tensor, dim: int) -> torch.Tensor:
    """5-tap filter along `dim`, taps accumulated in the JAX package's order."""
    n = img.shape[dim]
    padded = torch.index_select(img, dim, _reflect_index(n, 2, img.device))
    out = torch.zeros_like(img)
    for i, k in enumerate(_KERNEL5):
        out = out + padded.narrow(dim, i, n) * torch.tensor(k, dtype=img.dtype, device=img.device)
    return out


def pyr_down(frames: torch.Tensor) -> torch.Tensor:
    """Gaussian blur and decimation by 2 of `[K, H, W(, C)]` frames
    (cv::pyrDown semantics): rows filtered first, then columns."""
    blurred = _filter5(_filter5(frames, 1), 2)
    return blurred[:, ::2, ::2]


def depth_down(depth: torch.Tensor) -> torch.Tensor:
    """Zero-aware 2×2 mean of `[K, H, W]` depth maps: the mean of each
    cell's positive depths, 0 where it has none (``pyramid.cpp:116-141``)."""
    k = depth.shape[0]
    h2, w2 = depth.shape[1] // 2, depth.shape[2] // 2
    d = depth[:, : h2 * 2, : w2 * 2].reshape(k, h2, 2, w2, 2)
    vals = d.permute(0, 1, 3, 2, 4).reshape(k, h2, w2, 4)
    pos = vals > 0.0
    cnt = torch.sum(pos, dim=-1)
    s = torch.sum(torch.where(pos, vals, torch.zeros_like(vals)), dim=-1)
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1).to(depth.dtype), torch.zeros_like(s))
