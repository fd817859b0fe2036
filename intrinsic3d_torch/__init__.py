"""PyTorch/CUDA port of intrinsic3d, beside the JAX package.

Module paths mirror `intrinsic3d_tpu/` so each function's counterpart is
found under the same name. The port imports `torch` and numpy only: nothing
of JAX and nothing of `intrinsic3d_tpu` (whose package `__init__` imports
JAX), so numpy-only modules it needs are copied here.

Two paths are ported so far:
- the refinement outer step — `device_assembly` followed by one damped
  Gauss-Newton step (`gn_iteration`), joined in
  `refine.optimizer.fused_outer_step` — with the bicubic sampler and the
  nearest-pixel depth probe as hand-written CUDA kernels (`ops/bicubic.py`);
- keyframe selection and TSDF fusion (`apps.app_keyframes.run`,
  `apps.app_fusion.run`), with the dense distance-transform sweeps as a
  CUDA kernel (`ops/distance_transform.py`).
Kernel sources are in `csrc/`. Entry points run on the CUDA device unless
the caller passes `device="cpu"`.
"""
