"""Second-order spherical-harmonics basis (counterpart of
`intrinsic3d_tpu/lighting/sh.py`, reference ``shading.h:53-67``)."""

from __future__ import annotations

import torch

NUM_SH = 9


def sh_basis(n: torch.Tensor) -> torch.Tensor:
    """SH basis of normals `n [..., 3]` → `[..., 9]`:
    `{1, ny, nz, nx, nx·ny, ny·nz, −nx²−ny²+2nz², nx·nz, nx²−ny²}`."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    return torch.stack(
        [
            torch.ones_like(nx),
            ny,
            nz,
            nx,
            nx * ny,
            ny * nz,
            -nx * nx - ny * ny + 2.0 * nz * nz,
            nx * nz,
            nx * nx - ny * ny,
        ],
        dim=-1,
    )
