"""Bicubic sampler and nearest-pixel probe: CUDA kernels and plain versions.

Counterpart of `intrinsic3d_tpu/ops/pallas/bicubic.py`:

- `bicubic_rows` replaces `bicubic_sample_rows` (Pallas `_win_fwd_kernel` and
  `_win_fwdgrad_kernel`): masked Catmull-Rom sampling of `images[fid]` at
  (x, y), differentiable in x and y. The forward launches the
  value-plus-derivatives variant when x or y requires grad, so the backward
  is the elementwise `g·ddx`, `g·ddy` of `_rows_bwd`.
- `nearest_rows` replaces `nearest_sample_rows` (Pallas `_nearest_kernel`):
  `images[fid, yi, xi]`, 0 where inactive, no gradient.

On CUDA tensors the wrappers launch the kernels of `csrc/` (built by
`ops.build`) or raise; on CPU tensors they run the plain PyTorch versions
beside them (`bicubic_rows_plain`, `nearest_rows_plain`), which the CPU tests
hold against the JAX package and `chip_smoke.py` holds the kernels against.
`LAUNCHES` counts kernel launches (and only those).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from intrinsic3d_torch.ops import build

# kernel launches by entry, incremented where a kernel is launched and
# nowhere else; `reset_launches` zeroes them
LAUNCHES: Dict[str, int] = {"bicubic_rows_fwd": 0, "bicubic_rows_fwdgrad": 0, "nearest_rows": 0}

_VP = ctypes.c_void_p


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _catrom_w(t):
    t2 = t * t
    t3 = t2 * t
    return (
        -0.5 * t + t2 - 0.5 * t3,
        1.0 - 2.5 * t2 + 1.5 * t3,
        0.5 * t + 2.0 * t2 - 1.5 * t3,
        -0.5 * t2 + 0.5 * t3,
    )


def _catrom_dw(t):
    t2 = t * t
    return (
        -0.5 + 2.0 * t - 1.5 * t2,
        -5.0 * t + 4.5 * t2,
        0.5 + 4.0 * t - 4.5 * t2,
        -t + 1.5 * t2,
    )


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def bicubic_rows_plain(images, fid, x, y, active) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(value, ddx, ddy) `[M]` by 16 advanced-index gathers: the function
    the `bicubic_rows` kernel computes, in the same order of operations."""
    _, h, w = images.shape
    xmax, ymax = w - 2.001, h - 2.001
    xc = torch.clamp(x, 1.0, xmax)
    yc = torch.clamp(y, 1.0, ymax)
    x0f = torch.floor(xc)
    y0f = torch.floor(yc)
    wx, dwx = _catrom_w(xc - x0f), _catrom_dw(xc - x0f)
    wy, dwy = _catrom_w(yc - y0f), _catrom_dw(yc - y0f)
    f = fid.long()
    x0 = x0f.long() - 1
    y0 = y0f.long() - 1
    val = gx = gy = torch.zeros_like(x)
    for j in range(4):
        r = rd = torch.zeros_like(x)
        for i in range(4):
            v = images[f, y0 + j, x0 + i]
            r = r + wx[i] * v
            rd = rd + dwx[i] * v
        val = val + wy[j] * r
        gx = gx + wy[j] * rd
        gy = gy + dwy[j] * r
    act = active > 0.0
    zero = torch.zeros_like(val)
    in_x = (x >= 1.0) & (x < xmax)
    in_y = (y >= 1.0) & (y < ymax)
    return (
        torch.where(act, val, zero),
        torch.where(act & in_x, gx, zero),
        torch.where(act & in_y, gy, zero),
    )


def nearest_rows_plain(images, fid, yi, xi, active) -> torch.Tensor:
    """`images[fid, yi, xi]`, 0 where inactive (one advanced-index gather)."""
    v = images[fid, yi, xi]
    return torch.where(active > 0.0, v, torch.zeros_like(v))


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _check(images, ints, floats) -> None:
    dev = images.device
    if images.dim() != 3 or images.dtype != torch.float32 or not images.is_contiguous():
        raise ValueError("images must be a contiguous float32 [K, H, W] tensor")
    if images.shape[1] < 4 or images.shape[2] < 4:
        raise ValueError(f"images {tuple(images.shape)} smaller than the 4x4 bicubic support")
    m = floats[0].shape[0]
    for t, dtype in [(t, torch.int32) for t in ints] + [(t, torch.float32) for t in floats]:
        if t.device != dev or t.dtype != dtype or t.dim() != 1 or t.shape[0] != m:
            raise ValueError(
                f"per-element arrays must be 1-D {dtype} of length {m} on {dev}; "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError("per-element arrays must be contiguous")


# C signatures of the kernels' entry points (csrc/*.cu): pointers and the
# stream as void*, the element count as long long, sizes and flags as int
_SIGNATURES = {
    "bicubic_rows": [_VP] * 8 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP],
    "nearest_rows": [_VP] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VP],
}


def _entry(name: str):
    """The `i3d_<name>` C function, its argument types declared."""
    fn = getattr(build.load(name), f"i3d_{name}")
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _launch_bicubic(images, fid, x, y, active, with_grad: bool):
    _check(images, (fid,), (x, y, active))
    fn = _entry("bicubic_rows")
    out = torch.empty_like(x)
    ddx = torch.empty_like(x) if with_grad else None
    ddy = torch.empty_like(x) if with_grad else None
    with torch.cuda.device(x.device):
        rc = fn(
            images.data_ptr(), fid.data_ptr(), x.data_ptr(), y.data_ptr(), active.data_ptr(),
            out.data_ptr(),
            ddx.data_ptr() if with_grad else None,
            ddy.data_ptr() if with_grad else None,
            x.shape[0], images.shape[1], images.shape[2], int(with_grad),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"bicubic_rows kernel launch failed: CUDA error {rc}")
    LAUNCHES["bicubic_rows_fwdgrad" if with_grad else "bicubic_rows_fwd"] += 1
    return out, ddx, ddy


def _launch_nearest(images, fid, yi, xi, active):
    _check(images, (fid, yi, xi), (active,))
    fn = _entry("nearest_rows")
    out = torch.empty_like(active)
    with torch.cuda.device(active.device):
        rc = fn(
            images.data_ptr(), fid.data_ptr(), yi.data_ptr(), xi.data_ptr(), active.data_ptr(),
            out.data_ptr(), active.shape[0], images.shape[1], images.shape[2],
            torch.cuda.current_stream(active.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"nearest_rows kernel launch failed: CUDA error {rc}")
    LAUNCHES["nearest_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------


class _BicubicRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, images, fid, x, y, active):
        with_grad = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        if x.is_cuda:
            out, ddx, ddy = _launch_bicubic(images, fid, x, y, active, with_grad)
        else:
            out, ddx, ddy = bicubic_rows_plain(images, fid, x, y, active)
        if with_grad:
            ctx.save_for_backward(ddx, ddy)
        return out

    @staticmethod
    def backward(ctx, g):
        ddx, ddy = ctx.saved_tensors
        return None, None, g * ddx, g * ddy, None


def bicubic_rows(images, fid, x, y, active) -> torch.Tensor:
    """Masked Catmull-Rom sample `[M]` of `images [K, H, W]` (float32) at
    per-element `fid` (int32), `x`, `y`, `active` (float32, 0 ⇒ output 0 and
    zero gradient), all 1-D contiguous `[M]`. Coordinates are clipped to
    [1, W−2.001] × [1, H−2.001]; the gradient in x (y) is zeroed where the
    unclipped x (y) lies outside [1, W−2.001) ([1, H−2.001))."""
    return _BicubicRows.apply(images, fid, x, y, active)


def nearest_rows(images, fid, yi, xi, active) -> torch.Tensor:
    """`images[fid, yi, xi]` `[M]` for int32 indices pre-clipped to bounds,
    0 where `active` (float32) is 0."""
    if active.is_cuda:
        return _launch_nearest(images, fid, yi, xi, active)
    return nearest_rows_plain(images, fid, yi, xi, active)
