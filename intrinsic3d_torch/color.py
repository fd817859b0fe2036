"""Color/intensity conversion (counterpart of `intrinsic3d_tpu/color.py`,
reference ``color_util.cpp:41-80``)."""

from __future__ import annotations

import torch

# ITU-R BT.601 luma weights for RGB input
LUMA_R = 0.299
LUMA_G = 0.587
LUMA_B = 0.114


def intensity(rgb):
    """Luma of RGB `[..., 3]` (same scale as the input); tensors or arrays."""
    return LUMA_R * rgb[..., 0] + LUMA_G * rgb[..., 1] + LUMA_B * rgb[..., 2]


def chromacity(rgb: torch.Tensor) -> torch.Tensor:
    """Per-channel color divided by luma (``color_util.cpp:61-67``)."""
    lum = intensity(rgb)
    return rgb / torch.where(lum == 0.0, torch.full_like(lum, 1e-12), lum).unsqueeze(-1)


def scalar_to_color(scalar: torch.Tensor, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
    """Grayscale visualization mapping of a scalar field to [0, 255] RGB
    (``color_util.cpp:70-80``)."""
    g = torch.clamp((scalar - low) / (high - low), 0.0, 1.0) * 255.0
    return torch.stack([g, g, g], dim=-1)
