"""SDF differential operators (counterpart of `intrinsic3d_tpu/grid/ops.py`,
reference ``operators.h:70-86``)."""

from __future__ import annotations

import torch


def compute_normal_from_sdf4(sdf4: torch.Tensor) -> torch.Tensor:
    """Differentiable normal from an `[..., 4]` stencil {center, +x, +y, +z}.
    The `+1e-24` under the square root keeps the reverse pass finite where
    the forward difference vanishes."""
    n = torch.stack(
        [
            sdf4[..., 1] - sdf4[..., 0],
            sdf4[..., 2] - sdf4[..., 0],
            sdf4[..., 3] - sdf4[..., 0],
        ],
        dim=-1,
    )
    norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-24)
    return n / norm
