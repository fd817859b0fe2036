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


def shading_gradient_difference(lum4: torch.Tensor, shading4: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """E_g residual: the norm of (∇shading − ∇luminance) over forward
    differences of the `[..., 4]` values at {center, +x, +y, +z}
    (``shading.h:128-148``); `eps` under the square root keeps it
    differentiable at exactly 0."""
    diff = (shading4[..., 1:] - shading4[..., :1]) - (lum4[..., 1:] - lum4[..., :1])
    return torch.sqrt(torch.sum(diff * diff, dim=-1) + eps)
