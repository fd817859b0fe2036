"""Shared CLI plumbing for the three pipeline apps.

Mirrors the reference apps' two-flag interface (`-s sensor.yml -c stage.yml`,
``apps/src/app_fusion.cpp:71-77``) including the working-directory convention:
all paths in the configs are relative to the sensor config's folder
(``libintrinsic3d/src/filesystem.cpp:44-60``).

Copy of `intrinsic3d_tpu/apps/common.py`.
"""

from __future__ import annotations

import argparse
import logging
import os

from intrinsic3d_torch.config import SensorConfig, Settings
from intrinsic3d_torch.io.dataset import SensorI3D


def make_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-s", "--sensor", required=True, help="RGB-D sensor config (sensor.yml)")
    p.add_argument("-c", "--config", required=True, help="stage config (yml)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def setup_logging(verbose: bool = False):
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(message)s",
    )


def load_sensor(sensor_cfg_path: str) -> SensorI3D:
    """Load sensor settings, chdir to the config folder (reference behavior),
    and open the dataset."""
    sensor_cfg_path = os.path.abspath(sensor_cfg_path)
    settings = Settings.load(sensor_cfg_path)
    os.chdir(os.path.dirname(sensor_cfg_path))
    cfg = SensorConfig.from_settings(settings)
    return SensorI3D(cfg.dataset, cfg)


def ensure_parent(path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
