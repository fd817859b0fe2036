"""PyTorch/CUDA port of intrinsic3d, beside the JAX package.

Module paths mirror `intrinsic3d_tpu/` so each function's counterpart is
found under the same name. The port imports `torch`, numpy, scipy (the mesh
modules) and Pillow (PNG frames): nothing of JAX and nothing of
`intrinsic3d_tpu` (whose package `__init__` imports JAX), so numpy-only
modules it needs are copied here.

The user surface is the JAX package's: the three command-line apps
(`apps.app_keyframes`, `apps.app_fusion`, `apps.app_intrinsic3d`), which
read and write the reference's files (OpenCV-YAML configs, the on-disk
dataset, `keyframes.txt`, `.tsdf`, PLY, TUM poses, intrinsics). Under them:
keyframe selection and TSDF fusion, with the dense distance-transform sweeps
as a hand-written CUDA kernel (`ops/distance_transform.py`), and the double
coarse-to-fine refinement (`refine.intrinsic3d.Intrinsic3D`), whose outer
step — `device_assembly` followed by one damped Gauss-Newton step
(`gn_iteration`), joined in `refine.optimizer.fused_outer_step` — runs the
bicubic sampler and the nearest-pixel depth probe as CUDA kernels
(`ops/bicubic.py`). Kernel sources are in `csrc/`. Entry points run on the
CUDA device unless the caller passes `device="cpu"`.
"""
