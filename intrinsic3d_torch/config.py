"""Refinement configuration (copy of `intrinsic3d_tpu/config.py::RefinementConfig`).

Mirrors data/intrinsic3d.yml (Intrinsic3D::Config + Optimizer::Config). The
YAML `Settings` loader and the other stage configs stay in the JAX package
until the port reaches the apps.
"""

from __future__ import annotations

import dataclasses


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
    # "capped"); the port's slice runs the dense layout only
    frame_bucketing: str = "auto"
    # eliminate the dense global block {poses, intrinsics, distortion} from
    # the PCG through its damped Gram matrix (refine/solver.py)
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
