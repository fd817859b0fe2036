"""Configuration: OpenCV-YAML settings and the typed stage configs.

Copy of `intrinsic3d_tpu/config.py`. The reference stores every stage's
parameters in flat string-keyed OpenCV-YAML files (``%YAML:1.0`` header,
``libintrinsic3d/src/settings.cpp:70-163``); `Settings` reads and writes that
format with the same key names, and each stage config's `from_settings`
applies the defaults of data/*.yml.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, Optional


class Settings:
    """Flat string-keyed parameter store, loadable from OpenCV-YAML files.

    Mirrors the behavior of the reference ``nv::Settings``
    (``libintrinsic3d/include/nv/settings.h:48-74``): values are stored as strings
    and converted on access.
    """

    def __init__(self, values: Optional[Dict[str, str]] = None):
        self._values: Dict[str, str] = dict(values or {})

    # -- file I/O ----------------------------------------------------------

    @classmethod
    def load(cls, filename: str) -> "Settings":
        """Load an OpenCV-YAML (``%YAML:1.0``) or plain YAML settings file."""
        with open(filename, "r") as f:
            text = f.read()
        return cls.parse(text)

    @classmethod
    def parse(cls, text: str) -> "Settings":
        values: Dict[str, str] = {}
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("%YAML"):
                continue
            m = re.match(r"^([A-Za-z0-9_\-]+)\s*:\s*(.*)$", line)
            if not m:
                continue
            key, raw = m.group(1), m.group(2).strip()
            # strip surrounding quotes (OpenCV-YAML strings are quoted)
            if len(raw) >= 2 and raw[0] == raw[-1] and raw[0] in "\"'":
                raw = raw[1:-1]
            values[key] = raw
        return cls(values)

    def save(self, filename: str) -> None:
        with open(filename, "w") as f:
            f.write("%YAML:1.0\n\n")
            for k, v in self._values.items():
                f.write(f'{k}: "{v}"\n')

    # -- accessors ---------------------------------------------------------

    def exists(self, key: str) -> bool:
        return key in self._values

    def set(self, key: str, value: Any) -> None:
        if isinstance(value, bool):
            value = int(value)
        self._values[key] = str(value)

    def get_str(self, key: str, default: str = "") -> str:
        return self._values.get(key, default)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self._values.get(key)
        if v is None or v == "":
            return default
        return int(float(v))

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self._values.get(key)
        if v is None or v == "":
            return default
        return float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._values.get(key)
        if v is None or v == "":
            return default
        v = v.strip().lower()
        if v in ("true", "yes"):
            return True
        if v in ("false", "no"):
            return False
        return bool(int(float(v)))


def resolve_relative(cfg_path: str, path: str) -> str:
    """Resolve ``path`` relative to the directory containing ``cfg_path``.

    The reference chdirs into the sensor-config folder so that all dataset paths
    are relative to it (``libintrinsic3d/src/filesystem.cpp:44-60``). We resolve
    explicitly instead of mutating the process working directory.
    """
    if os.path.isabs(path) or not path:
        return path
    return os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(cfg_path)), path))


# ---------------------------------------------------------------------------
# Stage configs (defaults match the reference data/*.yml files)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SensorConfig:
    """Mirrors data/sensor.yml."""

    dataset: str = "./rgbd/"
    max_frames: int = 0
    min_depth: float = 0.1
    max_depth: float = 2.0

    @classmethod
    def from_settings(cls, s: Settings) -> "SensorConfig":
        return cls(
            dataset=s.get_str("dataset", "./rgbd/"),
            max_frames=s.get_int("max_frames", 0),
            min_depth=s.get_float("min_depth", 0.1),
            max_depth=s.get_float("max_depth", 2.0),
        )


@dataclasses.dataclass
class KeyframesConfig:
    """Mirrors data/keyframes.yml."""

    window_size: int = 20
    filename: str = "./fusion/keyframes.txt"
    show_keyframes: bool = False

    @classmethod
    def from_settings(cls, s: Settings) -> "KeyframesConfig":
        return cls(
            window_size=s.get_int("window_size", 20),
            filename=s.get_str("filename", "./fusion/keyframes.txt"),
            show_keyframes=s.get_bool("show_keyframes", False),
        )


@dataclasses.dataclass
class FusionConfig:
    """Mirrors data/fusion.yml."""

    keyframes: str = ""
    voxel_size: float = 0.004
    discont_window_size: int = 2
    clip_x0: float = 0.0
    clip_x1: float = 0.0
    clip_y0: float = 0.0
    clip_y1: float = 0.0
    clip_z0: float = 0.0
    clip_z1: float = 0.0
    output_mesh: str = ""
    output_sdf: str = ""

    @property
    def clip_bounds(self):
        return (self.clip_x0, self.clip_x1, self.clip_y0, self.clip_y1, self.clip_z0, self.clip_z1)

    @property
    def has_clip_bounds(self) -> bool:
        return any(abs(b) > 0.0 for b in self.clip_bounds)

    @classmethod
    def from_settings(cls, s: Settings) -> "FusionConfig":
        return cls(
            keyframes=s.get_str("keyframes", ""),
            voxel_size=s.get_float("voxel_size", 0.004),
            discont_window_size=s.get_int("discont_window_size", 2),
            clip_x0=s.get_float("clip_x0", 0.0),
            clip_x1=s.get_float("clip_x1", 0.0),
            clip_y0=s.get_float("clip_y0", 0.0),
            clip_y1=s.get_float("clip_y1", 0.0),
            clip_z0=s.get_float("clip_z0", 0.0),
            clip_z1=s.get_float("clip_z1", 0.0),
            output_mesh=s.get_str("output_mesh", ""),
            output_sdf=s.get_str("output_sdf", ""),
        )


@dataclasses.dataclass
class RefinementConfig:
    """Refinement settings; defaults are the reference YAML's values."""

    keyframes: str = "./fusion/keyframes.txt"
    input_sdf: str = "./fusion/volume_0.004.tsdf"

    num_grid_levels: int = 3
    num_rgbd_levels: int = 3
    thin_shell_factor: float = 2.0
    thin_shell_factor_final: float = 1.0
    subvolume_size_sh: float = 0.2
    subvolume_sh_lambda_reg: float = 10.0
    clear_distant_voxels: bool = True
    occlusion_distance: float = 0.02
    num_observations: int = 5

    lambda_g: float = 0.2
    lambda_r0: float = 80.0
    lambda_r1: float = 10.0
    lambda_s0: float = 120.0
    lambda_s1: float = 10.0
    lambda_a: float = 0.1
    iterations: int = 10
    lm_steps: int = 50
    fix_poses: bool = False
    fix_intrinsics: bool = False
    fix_distortion: bool = False
    # E_g element layout of the level loop ("auto" / "always" / "never" /
    # "capped"), planned by refine.optimizer.plan_eg_layout with the JAX
    # package's rules: dense, frame-bucketed, streamed over frame chunks, or
    # frame-capped
    frame_bucketing: str = "auto"
    # eliminate the dense global block {poses, intrinsics, distortion} from
    # the PCG through its damped Gram matrix (refine/solver.py); a free
    # camera's intrinsics and distortion stay in the PCG
    # (refine/optimizer.py::level_schur)
    schur_globals: bool = True
    # pose-observability gate (refine/device_assembly.py); 0 disables
    min_pose_obs: int = 24

    output_mesh_prefix: str = ""
    output_mesh_normals: bool = False
    output_mesh_laplacian: bool = False
    output_mesh_intensity: bool = False
    output_mesh_intensity_grad: bool = False
    output_mesh_albedo: bool = True
    output_mesh_shading_sv: bool = False
    output_mesh_shading_sv_const: bool = False
    output_mesh_chromacity: bool = False
    output_mesh_subvolumes: bool = False
    output_mesh_subvolumes_interpolated: bool = False
    output_mesh_largest_comp_only: bool = True
    output_poses_prefix: str = ""
    output_intrinsics_prefix: str = ""

    @classmethod
    def from_settings(cls, s: Settings) -> "RefinementConfig":
        d = cls()
        return cls(
            keyframes=s.get_str("keyframes", d.keyframes),
            input_sdf=s.get_str("input_sdf", d.input_sdf),
            num_grid_levels=s.get_int("num_grid_levels", d.num_grid_levels),
            num_rgbd_levels=s.get_int("num_rgbd_levels", d.num_rgbd_levels),
            thin_shell_factor=s.get_float("thin_shell_factor", d.thin_shell_factor),
            thin_shell_factor_final=s.get_float(
                "thin_shell_factor_final", d.thin_shell_factor_final
            ),
            # note: the reference config key has the "lamda" typo — accept both
            subvolume_size_sh=s.get_float("subvolume_size_sh", d.subvolume_size_sh),
            subvolume_sh_lambda_reg=s.get_float(
                "subvolume_sh_lambda_reg",
                s.get_float("subvolume_sh_lamda_reg", d.subvolume_sh_lambda_reg),
            ),
            clear_distant_voxels=s.get_bool("clear_distant_voxels", d.clear_distant_voxels),
            occlusion_distance=s.get_float("occlusion_distance", d.occlusion_distance),
            num_observations=s.get_int("num_observations", d.num_observations),
            lambda_g=s.get_float("lambda_g", d.lambda_g),
            lambda_r0=s.get_float("lambda_r0", d.lambda_r0),
            lambda_r1=s.get_float("lambda_r1", d.lambda_r1),
            lambda_s0=s.get_float("lambda_s0", d.lambda_s0),
            lambda_s1=s.get_float("lambda_s1", d.lambda_s1),
            lambda_a=s.get_float("lambda_a", d.lambda_a),
            iterations=s.get_int("iterations", d.iterations),
            lm_steps=s.get_int("lm_steps", d.lm_steps),
            fix_poses=s.get_bool("fix_poses", d.fix_poses),
            fix_intrinsics=s.get_bool("fix_intrinsics", d.fix_intrinsics),
            fix_distortion=s.get_bool("fix_distortion", d.fix_distortion),
            frame_bucketing=s.get_str("frame_bucketing", d.frame_bucketing),
            schur_globals=s.get_bool("schur_globals", d.schur_globals),
            min_pose_obs=s.get_int("min_pose_obs", d.min_pose_obs),
            output_mesh_prefix=s.get_str("output_mesh_prefix", d.output_mesh_prefix),
            output_mesh_normals=s.get_bool("output_mesh_normals", d.output_mesh_normals),
            output_mesh_laplacian=s.get_bool("output_mesh_laplacian", d.output_mesh_laplacian),
            output_mesh_intensity=s.get_bool("output_mesh_intensity", d.output_mesh_intensity),
            output_mesh_intensity_grad=s.get_bool(
                "output_mesh_intensity_grad", d.output_mesh_intensity_grad
            ),
            output_mesh_albedo=s.get_bool("output_mesh_albedo", d.output_mesh_albedo),
            output_mesh_shading_sv=s.get_bool("output_mesh_shading_sv", d.output_mesh_shading_sv),
            output_mesh_shading_sv_const=s.get_bool(
                "output_mesh_shading_sv_const", d.output_mesh_shading_sv_const
            ),
            output_mesh_chromacity=s.get_bool("output_mesh_chromacity", d.output_mesh_chromacity),
            output_mesh_subvolumes=s.get_bool("output_mesh_subvolumes", d.output_mesh_subvolumes),
            output_mesh_subvolumes_interpolated=s.get_bool(
                "output_mesh_subvolumes_interpolated", d.output_mesh_subvolumes_interpolated
            ),
            output_mesh_largest_comp_only=s.get_bool(
                "output_mesh_largest_comp_only", d.output_mesh_largest_comp_only
            ),
            output_poses_prefix=s.get_str("output_poses_prefix", d.output_poses_prefix),
            output_intrinsics_prefix=s.get_str(
                "output_intrinsics_prefix", d.output_intrinsics_prefix
            ),
        )
