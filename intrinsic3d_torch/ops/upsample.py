"""Field resampling of the grid-level ×2 upsample: CUDA kernel and plain version.

The function of `grid.algorithms._upsample_fields` followed by its reorder
into the child grid's key order, per child: child `j` of the key order is
entry `o = order[j]` of the parent-major order, the child at corner offset
`o % 8` of parent `o // 8`, and its fields are the parent's 8 corners
(`idx[o // 8]`, −1 absent) weighted by the fixed `_UP_W8[o % 8]` where the
corner is present with weight > 0. Scalar fields sum the 8 products as
numpy's pairwise tree, colour channels one after another, and both divide
by the weights' sum; the weight is zeroed where at most 4 corners are valid
and clamped at 0. Every operation rounds once in float32, as numpy's do.

On CUDA tensors `upsample_fields` launches `csrc/upsample_fields.cu` (built
by `ops.build`) once, counted in `build.LAUNCHES["upsample_fields"]`, or
raises; `upsample_fields_plain` is the same arithmetic in PyTorch on any
device, which the CPU tests hold bitwise to the host path and
`chip_smoke.py` holds the kernel to on the card, on the parent grids of
the pipeline refinement's grid-level boundaries.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from intrinsic3d_torch.ops import build

# the parent's fields the kernel resamples, [N] each but color [N, 3];
# albedo and sdf_refined only on a grid that has them
FIELDS = ("sdf", "weight", "color", "albedo", "sdf_refined")
# offsets of a parent's 8 corners and of its 8 children, in the JAX
# package's order (`grid.algorithms._CORNER_OFFS`; the kernel's `corner_bits`)
CORNER_OFFS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (0, 1, 1), (1, 0, 1), (1, 1, 1))

_VP = ctypes.c_void_p
_SIGNATURE = [_VP] * 7 + [ctypes.c_int] + [_VP] * 6


def child_weights(device=None) -> torch.Tensor:
    """The `[child c, corner k]` float32 table of trilinear weights (each a
    product of 0, 0.5 and 1, so exact): `grid.algorithms._UP_W8`."""
    offs = torch.tensor(CORNER_OFFS, dtype=torch.float32, device=device)
    half = offs[:, None, :] * 0.5
    return torch.where(offs[None, :, :] == 1, half, 1.0 - half).prod(dim=-1)


def _names(fields: Dict[str, torch.Tensor]):
    sbr = "albedo" in fields or "sdf_refined" in fields
    return FIELDS if sbr else FIELDS[:3]


def _check(fields: Dict[str, torch.Tensor], idx: torch.Tensor, order: torch.Tensor) -> int:
    """The number of parents, after checking the kernel's layouts: float32
    contiguous fields of one length on one CUDA device, int32 contiguous
    `idx [N, 8]` and `order [8N]` there too."""
    names = _names(fields)
    if set(fields) != set(names):
        raise ValueError(f"fields must be {FIELDS[:3]} or all of {FIELDS}, not {tuple(fields)}")
    n = idx.shape[0] if idx.dim() == 2 else -1
    dev = fields["sdf"].device
    for name in names:
        t = fields[name]
        want = (n, 3) if name == "color" else (n,)
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"{name} must be a float32 {want} tensor, not {t.dtype} {tuple(t.shape)}")
    for name, t, want in (("idx", idx, (n, 8)), ("order", order, (8 * n,))):
        if t.dtype != torch.int32 or tuple(t.shape) != want:
            raise ValueError(f"{name} must be an int32 {want} tensor, not {t.dtype} {tuple(t.shape)}")
    tensors = [fields[k] for k in names] + [idx, order]
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"the kernel takes tensors on one CUDA device, not {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fields, idx and order must be contiguous")
    if 8 * n > 2**31 - 1:
        raise ValueError(f"{8 * n} children exceed the kernel's int32 indices")
    return n


def upsample_fields(fields: Dict[str, torch.Tensor], idx: torch.Tensor, order: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The children's fields in key order, by one launch of the kernel on
    the current stream (counted in `build.LAUNCHES["upsample_fields"]`).
    Takes CUDA tensors only (`_check`); `upsample_fields_plain` is the same
    function on any device."""
    n = _check(fields, idx, order)
    names = _names(fields)
    out = {k: torch.empty((8 * n, 3) if k == "color" else (8 * n,), dtype=torch.float32, device=idx.device)
           for k in names}
    if n == 0:
        return out
    fn = build.load("upsample_fields").i3d_upsample_fields
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int

    def ptr(d, k):
        return d[k].data_ptr() if k in d else None

    with torch.cuda.device(idx.device):
        rc = fn(*(ptr(fields, k) for k in FIELDS), idx.data_ptr(), order.data_ptr(), n,
                *(ptr(out, k) for k in FIELDS), torch.cuda.current_stream(idx.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"upsample_fields kernel launch failed for {n} parents: CUDA error {rc}")
    build.LAUNCHES["upsample_fields"] += 1
    return out


def upsample_fields_plain(fields: Dict[str, torch.Tensor], idx: torch.Tensor, order: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The kernel's function in PyTorch, operation for operation (each
    product, sum and quotient one float32 rounding): the children's fields
    in key order from the parent's `fields`, the corner table `idx [N, 8]`
    and the key order `order [8N]`."""
    o = order.long()
    nb = idx.long()[o // 8]  # [8N, 8]
    at = nb.clamp(min=0)
    weight = fields["weight"]
    valid = (nb >= 0) & (weight[at] > 0.0)
    w = torch.where(valid, child_weights(idx.device)[o % 8], 0.0)
    cnt = valid.sum(dim=-1)
    wsum = w.sum(dim=-1)  # exact: multiples of 1/8 up to 1
    wsafe = torch.where(wsum > 0.0, wsum, 1.0)

    def scalar(f):
        t = (f[at] * w).unbind(dim=-1)
        return (((t[0] + t[1]) + (t[2] + t[3])) + ((t[4] + t[5]) + (t[6] + t[7]))) / wsafe

    def vector(f):
        v = f[at]  # [8N, 8, 3]
        s = v[:, 0] * w[:, 0, None]
        for k in range(1, 8):
            s = s + v[:, k] * w[:, k, None]
        return s / wsafe[:, None]

    wt = torch.where(cnt > 4, scalar(weight), 0.0)
    out = {"sdf": scalar(fields["sdf"]), "weight": torch.where((wt >= 0.0) | torch.isnan(wt), wt, 0.0),
           "color": vector(fields["color"])}
    if "albedo" in fields:
        out["albedo"] = scalar(fields["albedo"])
        out["sdf_refined"] = scalar(fields["sdf_refined"])
    return out
