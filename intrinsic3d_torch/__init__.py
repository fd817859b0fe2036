"""PyTorch/CUDA port of the intrinsic3d refinement, beside the JAX package.

Module paths mirror `intrinsic3d_tpu/` so each function's counterpart is
found under the same name. The port imports `torch` and numpy only: nothing
of JAX and nothing of `intrinsic3d_tpu` (whose package `__init__` imports
JAX), so numpy-only modules it needs are copied here.

This first slice covers the refinement outer step — `device_assembly`
followed by one damped Gauss-Newton step (`gn_iteration`), joined in
`refine.optimizer.fused_outer_step` — with the bicubic sampler and the
nearest-pixel depth probe as hand-written CUDA kernels (`ops/bicubic.py`,
`csrc/`). Entry points run on the CUDA device unless the caller passes
`device="cpu"`.
"""
