"""Crete-2007 no-reference perceptual blur metric.

Counterpart of `intrinsic3d_tpu/image/blur.py` (reference
``KeyframeSelection::estimateBlurCrete``, ``keyframe_selection.cpp:240-310``):
9-tap box blur along each axis, directional absolute-difference images,
variation ratio, and the score 1 − max(b_ver, b_hor) (1.0 = sharpest). Every
function takes leading frame axes, so a stack of frames is one call on the
device its tensor lies on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from intrinsic3d_torch.color import intensity as rgb_intensity


def _box9(img: torch.Tensor, axis: int) -> torch.Tensor:
    """9-tap box filter of `[..., H, W]` along H (`axis=0`) or W (`axis=1`)
    with REFLECT_101 borders (cv::filter2D's default; `F.pad`'s "reflect")."""
    h, w = img.shape[-2], img.shape[-1]
    pad = (0, 0, 4, 4) if axis == 0 else (4, 4, 0, 0)
    ap = F.pad(img.reshape(-1, 1, h, w), pad, mode="reflect").reshape(
        *img.shape[:-2], h + pad[2] + pad[3], w + pad[0] + pad[1]
    )
    out = torch.zeros_like(img)
    for i in range(9):
        out = out + (ap[..., i : i + h, :] if axis == 0 else ap[..., :, i : i + w])
    return out / 9.0


def blur_score_gray(gray: torch.Tensor) -> torch.Tensor:
    """Blur score of grayscale images `[..., H, W]` in [0, 1]; higher = sharper."""
    b_ver = _box9(gray, 0)
    b_hor = _box9(gray, 1)

    d_f_ver = torch.abs(gray[..., 1:, :] - gray[..., :-1, :])
    d_b_ver = torch.abs(b_ver[..., 1:, :] - b_ver[..., :-1, :])
    d_f_hor = torch.abs(gray[..., :, 1:] - gray[..., :, :-1])
    d_b_hor = torch.abs(b_hor[..., :, 1:] - b_hor[..., :, :-1])

    v_ver = torch.clamp(d_f_ver - d_b_ver, min=0.0)
    v_hor = torch.clamp(d_f_hor - d_b_hor, min=0.0)

    s_f_ver = d_f_ver.sum(dim=(-2, -1))
    s_v_ver = v_ver.sum(dim=(-2, -1))
    s_f_hor = d_f_hor.sum(dim=(-2, -1))
    s_v_hor = v_hor.sum(dim=(-2, -1))

    one = torch.ones_like(s_f_ver)
    b_f_ver = (s_f_ver - s_v_ver) / torch.where(s_f_ver == 0.0, one, s_f_ver)
    b_f_hor = (s_f_hor - s_v_hor) / torch.where(s_f_hor == 0.0, one, s_f_hor)
    return 1.0 - torch.maximum(b_f_ver, b_f_hor)


def blur_score_rgb(color: torch.Tensor) -> torch.Tensor:
    """Blur score of RGB images `[..., H, W, 3]` in [0, 1]."""
    return blur_score_gray(rgb_intensity(color))


def blur_scores_batch(frames: torch.Tensor) -> torch.Tensor:
    """Blur scores `[F]` of a stack of RGB frames `[F, H, W, 3]`, computed on
    the device `frames` lies on."""
    return blur_score_rgb(frames)
