"""Keyframe selection CLI (counterpart of `intrinsic3d_tpu/apps/app_keyframes.py`,
the reference's AppKeyframes, ``apps/src/app_keyframes.cpp``): score every
frame with the Crete blur metric on the device, pick the best per window,
write keyframes.txt.

Usage: python -m intrinsic3d_torch.apps.app_keyframes -s sensor.yml -c keyframes.yml
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from intrinsic3d_torch.apps.common import ensure_parent, load_sensor, make_parser, setup_logging
from intrinsic3d_torch.config import KeyframesConfig, Settings
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


def export_keyframes(sensor, sel: KeyframeSelection, out_dir: str) -> None:
    """Headless equivalent of the reference's interactive `show_keyframes`
    viewer (``app_keyframes.cpp:128-141`` + ``keyframe_selection.cpp:129-136``):
    export each selected keyframe with its blur score drawn, as PNGs."""
    from PIL import Image, ImageDraw

    os.makedirs(out_dir or ".", exist_ok=True)
    for i, is_kf in enumerate(sel.is_keyframe):
        if not is_kf:
            continue
        rgb = np.asarray(sensor.color(i))
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)
        img = Image.fromarray(rgb)
        draw = ImageDraw.Draw(img)
        draw.text((10, 38), f"score: {sel.frame_scores[i]:.6f}", fill=(0, 255, 0))
        path = os.path.join(out_dir or ".", f"keyframe_{i:06d}.png")
        img.save(path)
        log.info("   exported %s", path)


def main(argv=None, device="cuda"):
    args = make_parser("Blur-score keyframe selection").parse_args(argv)
    setup_logging(args.verbose)
    sensor = load_sensor(args.sensor)
    cfg = KeyframesConfig.from_settings(Settings.load(args.config))
    sel = run(sensor, cfg, device=device)
    if cfg.filename:
        ensure_parent(cfg.filename)
        sel.save(cfg.filename)
        log.info("saved %s", cfg.filename)
    if cfg.show_keyframes:
        export_keyframes(sensor, sel, os.path.dirname(cfg.filename))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
