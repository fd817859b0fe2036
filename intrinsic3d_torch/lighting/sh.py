"""Second-order spherical-harmonics basis and Lambertian shading
(counterpart of `intrinsic3d_tpu/lighting/sh.py`, reference
``shading.h:53-112``)."""

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


def compute_shading(sh_coeffs: torch.Tensor, normal: torch.Tensor, albedo: torch.Tensor) -> torch.Tensor:
    """`albedo · Σ l_k H_k(n)` (``shading.h:73-112``): sh_coeffs `[..., 9]`,
    normal `[..., 3]`, albedo `[...]` → shading `[...]`."""
    return albedo * torch.sum(sh_basis(normal) * sh_coeffs, dim=-1)
