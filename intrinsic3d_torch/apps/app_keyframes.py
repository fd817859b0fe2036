"""Keyframe selection (counterpart of `intrinsic3d_tpu/apps/app_keyframes.py`,
the reference's AppKeyframes, ``apps/src/app_keyframes.cpp``): score every
frame with the Crete blur metric on the device, pick the best per window.
The command-line `main()`, its YAML settings and the PNG export wait for the
port's apps stage.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from intrinsic3d_torch.config import KeyframesConfig
from intrinsic3d_torch.device import resolve_device
from intrinsic3d_torch.image.blur import blur_scores_batch
from intrinsic3d_torch.keyframes import KeyframeSelection

log = logging.getLogger("intrinsic3d")


def run(sensor, cfg: KeyframesConfig, batch: int = 16, device="cuda") -> KeyframeSelection:
    """Blur scores of all frames in stacks of `batch` on `device`, then the
    best-in-window selection."""
    dev = resolve_device(device)
    sel = KeyframeSelection(window_size=cfg.window_size)
    n = sensor.num_frames
    for beg in range(0, n, batch):
        end = min(beg + batch, n)
        frames = np.stack([np.asarray(sensor.color(i), np.float32) for i in range(beg, end)])
        scores = blur_scores_batch(torch.as_tensor(frames, device=dev)).cpu().numpy()
        sel.add_scores(scores.tolist())
        log.info("   scored frames %d..%d", beg, end - 1)
    sel.select()
    log.info("%d keyframes selected out of %d frames", sel.count(), n)
    return sel
