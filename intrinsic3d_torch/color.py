"""Color/intensity conversion (counterpart of `intrinsic3d_tpu/color.py`,
reference ``color_util.cpp:41-58``)."""

from __future__ import annotations

# ITU-R BT.601 luma weights for RGB input
LUMA_R = 0.299
LUMA_G = 0.587
LUMA_B = 0.114


def intensity(rgb):
    """Luma of RGB `[..., 3]` (same scale as the input); tensors or arrays."""
    return LUMA_R * rgb[..., 0] + LUMA_G * rgb[..., 1] + LUMA_B * rgb[..., 2]
