"""Keyframe selection: the Crete-2007 blur score of each frame and the best
frame of each window (keyframe_selection.cpp:73-106, 240-310)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.common import intensity


def _box9(img, axis: int):
    h, w = img.shape[-2], img.shape[-1]
    pad = (0, 0, 4, 4) if axis == 0 else (4, 4, 0, 0)
    # reflect padding exists for float32 and float64 only; the sums run in
    # the image's own type
    src = img if img.dtype in (torch.float32, torch.float64) else img.float()
    ap = F.pad(src.reshape(-1, 1, h, w), pad, mode="reflect").to(img.dtype)
    ap = ap.reshape(*img.shape[:-2], h + pad[2] + pad[3], w + pad[0] + pad[1])
    out = torch.zeros_like(img)
    for i in range(9):
        out = out + (ap[..., i:i + h, :] if axis == 0 else ap[..., :, i:i + w])
    return out / 9.0


def blur_scores(colors: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Scores `[F]` of RGB frames `[F, H, W, 3]` in [0, 1]; higher is
    sharper. Computed in `dtype`."""
    gray = intensity(colors.to(dtype))
    bv, bh = _box9(gray, 0), _box9(gray, 1)
    dfv = torch.abs(gray[..., 1:, :] - gray[..., :-1, :])
    dbv = torch.abs(bv[..., 1:, :] - bv[..., :-1, :])
    dfh = torch.abs(gray[..., :, 1:] - gray[..., :, :-1])
    dbh = torch.abs(bh[..., :, 1:] - bh[..., :, :-1])
    sfv, svv = dfv.sum(dim=(-2, -1)), torch.clamp(dfv - dbv, min=0).sum(dim=(-2, -1))
    sfh, svh = dfh.sum(dim=(-2, -1)), torch.clamp(dfh - dbh, min=0).sum(dim=(-2, -1))
    one = torch.ones_like(sfv)
    bfv = (sfv - svv) / torch.where(sfv == 0, one, sfv)
    bfh = (sfh - svh) / torch.where(sfh == 0, one, sfh)
    return 1.0 - torch.maximum(bfv, bfh)


def select(scores, window: int) -> list:
    """Ids of the best-scoring frame of each window; the window's first frame
    when no score is positive."""
    s = [float(v) for v in scores]
    ids = []
    for beg in range(0, len(s), window):
        win = s[beg:beg + window]
        ids.append(beg + max(range(len(win)), key=lambda i: (win[i], -i)) if any(v > 0 for v in win) else beg)
    return ids
