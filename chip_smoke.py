#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`intrinsic3d_torch`) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `intrinsic3d_torch/csrc/` with nvcc
(one process per source, all at once), then drives the port's three stages.

The refinement outer step:
1. drives it once at the benchmark's scale (bench.py: voxel 0.004 m,
   320x240, 8 keyframes, 142,256 voxels) as a warm-up, recording the inputs
   the path hands each kernel (the E_g kernel's from its first
   linearization; K1a's and K1b's are those the eager E_g forward of that
   linearized chunk hands the sampler, `path_inputs`: the card's block
   path samples inside the E_g kernel, the flat path through K1a and K1b);
2. holds every kernel of the path against its plain PyTorch version on those
   inputs and times kernel (in a CUDA graph, from Python, and one call at a
   time with the L2 cache flushed before it, the time its bound is held
   against), plain version and (where one exists) the one PyTorch call
   computing the same function;
3. zeroes the launch counters, drives 5 chained outer iterations through
   `refine.optimizer.fused_outer_step`, and reads the counters (every kernel
   of the path must have run);
4. checks the result on a small problem against the port's plain CPU path
   (which the repo's tests hold against the JAX package);
5. drives the flat-table oracle on the same bench-scale problem: builds
   `SphereProblem.assemble()` on the card (its active E_g count printed
   beside the block assembly's), recording in a warm-up flat outer step the
   inputs the flat path hands each kernel; holds the bicubic and
   depth-probe kernels against their plain versions on those inputs (the
   `flat` sub-record of each kernel record); re-lays the problem with
   `to_block_problem`, holds flat against block costs (rtol 1e-4) and
   gradients (rtol 2e-4 with an absolute floor of 2e-4 x the leaf's
   largest magnitude, at least 1e-6: both are atomic sums in different
   orders), and prints, from float64 copies of both problems sampled
   through the plain sampler on the card, the float64 flat-vs-block
   gradient gap (bar 1e-9 x the leaf's largest magnitude) and each float32
   path's error against float64, which the floor must cover; takes one
   flat `gn_iteration` (3 LM tries, 6 CG steps) against the block one in
   float32 (cost before rtol 1e-4, after rtol 1e-3; sdf and poses rtol
   5e-3, atol 5e-6; no accepted cost rises), times the flat and block steps
   with the launch counters zeroed just before the flat outer step
   (assembly + step) and read just after (`launches_flat`, where the
   bicubic and depth-probe kernels must have run), and runs
   `optimize_level(use_blocks=False)` for 3 iterations on the small sphere
   of step 4 (no accepted cost may rise).

Keyframe selection and TSDF fusion (stages 1 and 2 of bench_pipeline.py: 30
frames at 640x480, voxel 0.004 m, clip bounds +-2.5 radius):
6. builds the orbit dataset on the host, runs `app_keyframes.run` and
   `app_fusion.run` on the card once as a warm-up (recording the dense
   distance-transform kernel's inputs), then again with the counters zeroed
   just before and read just after, and holds the fused SDF to the analytic
   sphere.

The refinement (stage 3 of bench_pipeline.py: 3 grid levels from 4 mm to
1 mm, 3 pyramid levels, 10 outer iterations each, 5 observations, 50 LM
tries, 12 CG steps):
7. refines the measured run's fused grid with `Intrinsic3D.refine` from the
   sensor's initial poses, the counters zeroed just before and read just
   after; prints each level's size, plan, iteration times, costs, tries, mu
   and peak memory (bytes per dense element), the phase seconds and how far
   the poses moved from the true ones (printed, not checked); fails
   unless the schedule is (2,2) (2,1) (2,0) (1,0) (0,0), every level is
   dense, no accepted cost rises, every field is finite, the voxel size
   ends at 1 mm, the E_g and depth-probe kernels launched, the upsample
   kernel launched once a grid-level boundary, and the refined SDF meets
   the analytic sphere's bar. It keeps a host copy of
   the inputs of each level's first E_g kernel call of each mode
   (linearization, value) and first K2 (depth probe) call inside
   `optimize_level` (off the card, so the levels' peak memory holds none of
   it; the copies' seconds are printed) and the level's launches, holds the
   kernels against their plain versions on them after the run (the E_g
   kernel on its frame row with the most nonzero residuals, against the
   float64 evaluation, `eg_figures`), and prints per level M, the active
   share, the times, the bound and the share of the bound, and per kernel
   the sum over levels of launches x L2-flushed ms (the `levels` and
   `main_path_ms` of the E_g and K2 records). It also keeps a host copy of
   the parent grid each grid-level boundary hands `grid.algorithms.upsample`
   and holds the upsample kernel there, bit for bit, against its plain
   version on the card and the host path (numpy resampling and reorder),
   timing the kernel (CUDA graph, from Python, L2-flushed) beside its byte
   bound, the card's whole step (upload, launch, copy back) and the host's
   (`check_upsample`; the record's figures are the finest boundary's, each
   boundary's under `boundaries`). On each grid level's grid (those parents
   and the refined grid) it holds the level-statics kernel bit for bit to
   the host build and times it likewise, beside the card's whole build and
   the host's (`check_level_static`); the kernel must have launched once a
   level. The refinement runs
   with the level pipeline on (the default): each level's layout and plan,
   and each grid-level boundary's upsample and sparsify index tables, built
   on background threads, each level's statics on the card after its join;
7a. refines the same fused grid four more times, capturing nothing, with
   the level pipeline off, on, on and off (`Intrinsic3D(prefetch=)`);
   prints each run's wall clock, its phases by kind and by name (the
   threads' own seconds under `prefetch` and `upsample_prep`) and each
   level's median outer iteration (chiprun_out/prefetch_ab.json and each
   run's <tag>_levels.json); fails unless every run meets step 7's bars,
   plans every level as step 7 did (plan, bucket blocks, chunks) and
   starts from step 7's first cost (rtol 1e-5; the gaps between runs of
   one setting and between the settings are printed).

The multi-device refinement (`intrinsic3d_torch.parallel`, ranks spawned
by `parallel.dryrun.launch` after the kernels and the native library are
built here, each rank failing the phase if it raises or outlives its
timeout):
7b. refines the same fused grid with `Intrinsic3D(mesh=)` on two ranks that
   share the card over gloo, the counters zeroed in each rank just before
   and read just after; prints per rank its brick rows and halo rows per
   mesh shift, its peak memory, the seconds per outer iteration at the
   finest level, its collectives (calls and seconds) and its E_g and K2
   launches, and per level its costs beside step 7's; then, on the same
   ranks, runs 2 outer iterations of `optimize_level(mesh=)` (the outer
   loop `Intrinsic3D(mesh=)` runs each level through) from each level's
   recorded start in step 7. Fails unless the first level's first cost
   (the same inputs as step 7's) and, from every level's recorded start,
   the first cost and the cost after the first sharded GN step are within
   rtol 1e-3 of step 7's, no accepted cost rises,
   the refined SDF meets step 7's bar, every per-voxel field a rank held is
   about half of it, and each rank launched the E_g kernel and K2; rank 0
   holds K1a, K1b, K2 and the E_g kernel against their plain versions on
   its first inputs (the `multidevice` sub-record). The later levels of the two runs start where
   each run's own trajectory ended; how far rounding moves that is printed
   from step 7 run again with 1e-7 colour noise (not gated);
7c. runs the dry run `python -m intrinsic3d_torch.parallel.dryrun` at 4
   ranks over gloo on the card (the small problems of the JAX dry run, more
   than one mesh shift), each phase against the single-device port;
7d. runs `optimize_level(mesh=)` on one rank over NCCL against
   `mesh=None` on the small problem (costs rtol 1e-4, then 1e-3).

The three command-line apps (`GoldenSceneSpec.full_scale()`: 30 frames at
640x480 on disk, 4 mm -> 1 mm over 3 grid and 3 RGB-D levels, 10
iterations, poses free):
8. exports the golden dataset under build/, zeroes the counters, runs
   `app_keyframes.main`, `app_fusion.main` and `app_intrinsic3d.main` with
   their default device, and reads the counters; prints each app's wall
   clock, the refinement app's export seconds against its refinement, the
   launches, the finest refined mesh's distance to the analytic sphere, the
   keyframe centres' drift, and `LevelTopology.build` of each grid level
   through the native library against the numpy route
   (chiprun_out/apps.json); fails unless keyframes.txt selects what
   `app_keyframes.run` does, the .tsdf reloads bit for bit to
   `app_fusion.run`'s grid, every level's meshes, poses and intrinsics load
   finite, the E_g kernel, K2 and K3 launched, the finest mesh's median distance
   is under half a finest voxel and every keyframe centre stays within
   0.2 m of the orbit.

Many keyframes (bench_pipeline.py --frames 90: the same orbit with 90
frames, so 30 keyframes; the finest level's dense E_g elements exceed the
card's budget):
9. runs keyframes and fusion, then refines the fused grid with
   `Intrinsic3D.refine` as in step 7, the counters zeroed just before and
   read just after; prints each level's plan (bucket blocks, chunks) and the
   budget arithmetic of every bucketed level; fails unless step 7's bars
   hold, the finest level is frame-bucketed by the planner's own rules and
   no level is frame-capped where one-frame chunks of its exact buckets fit;
10. from the recorded start of a level, runs 2 outer iterations twice: at
   2 mm, bucketed one-shot against streamed in 2 chunks; at the finest level
   (whose exact buckets do not fit one-shot), the planner's chunks against
   twice as many; with float32 coefficients the pair must agree (first cost
   rtol 1e-4, trajectory rtol 2e-2), with the production bfloat16 ones the
   difference is printed;
11. holds the E_g, bicubic and depth-probe kernels against their plain
    versions on the inputs of the finest bucketed level's first
    linearization (`path_inputs`) and first depth-probe call.

Then:
12. holds the distance-transform kernel (several sweeps fused per launch)
    against its plain version bit for bit on the path's window and on a
    411x211x501 field (the Lion dataset's crop volume at 4 mm), with its
    sweeps per launch, launches per call and share of its bound, and the
    masked sampler's forward and backward (on no path) on the sampler
    inputs of step 1;
13. checks a small fusion problem and a small refinement (the JAX
    package's end-to-end scene) on the card against the CPU path;
14. runs the benchmark twins through their `main`, each printing its JSON
    line: `intrinsic3d_torch.bench` at its defaults (its active E_g count
    must equal step 5's) and `intrinsic3d_torch.bench_pipeline --modes auto
    --repeats 1` (its refined mesh within half a finest voxel of the sphere,
    0.5 mm rms, and its phases not empty).

Prints the card (`nvidia-smi` name and power limit), one line per phase,
the twins' JSON lines, a JSON `{"kernels": [...]}` line, and as the last line
`{"ok": true, "device": {...}}`; every line it prints is also kept in
chiprun_out/chip_smoke.log. Exits non-zero on any failure, and when no
CUDA device is available. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
LOG = REPO / "chiprun_out" / "chip_smoke.log"

# operations per neighbour of a valid voxel in one sweep, the least the
# function needs: csrc/correct_sdf_dense.cu folds the sign test and the min
# with the best into one integer min of the neighbour's bits (the class's
# step is added once per voxel; index arithmetic and shared-memory reads not
# counted)
DT_OPS_PER_NEIGHBOUR = 1
DT_ITERS = 10
# the reference's Lion crop volume at 4 mm (BASELINE.md): x in [-0.09, 1.55],
# y in [-0.58, 0.26], z in [0, 2.0]
DT_FIELD = (411, 211, 501)
CHAINED_ITERS = 5


# the kernels of the card's block solve: the E_g pass (both modes) and the
# depth probe; the sampler entries K1a and K1b run on the flat path
BLOCK_PATH_KERNELS = ("eg_rows_lin", "eg_rows_value", "nearest_rows")


def log(*a):
    """Print a line, and append it to chiprun_out/chip_smoke.log (the whole
    run's lines, of which the card tool returns only the last ones)."""
    text = " ".join(str(x) for x in a)
    print(text, flush=True)
    LOG.parent.mkdir(exist_ok=True)
    with open(LOG, "a") as f:
        f.write(text + "\n")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean ms per call of `fn` issued from Python (CUDA events around `reps`
    back-to-back calls after a warm-up): device time plus whatever launch
    gaps the host leaves."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device ms per call of `fn`: `reps` calls captured in one CUDA
    graph and replayed, so no host launch gap enters the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture_first_call(module, name: str, store: dict, key: str = "", when=None, to_host: bool = False,
                       pick=None):
    """Wrap `module.name` so the arguments of its first call (for which
    `when(args)` holds, when given) are kept (`pick(args)` of them, when
    given; tensors, also inside named tuples, cloned; with `to_host`, copied
    to the host, so they take no device memory, and the copy's seconds added
    to `store["capture_s"]`) under `key` (default `name`)."""
    import torch

    orig = getattr(module, name)
    key = key or name

    def copy(a):
        if torch.is_tensor(a):
            return a.detach().cpu() if to_host else a.detach().clone()
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            return type(a)(*(copy(t) for t in a))
        return a

    def wrapper(*args):
        if key not in store and (when is None or when(args)):
            t0 = time.perf_counter()
            store[key] = tuple(copy(a) for a in (pick(args) if pick else args))
            if to_host:
                store["capture_s"] = store.get("capture_s", 0.0) + time.perf_counter() - t0
        return orig(*args)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, orig)


def capture_linearization(store: dict):
    """Keep (by reference) the (params, assembly, frame chunks) of the first
    block linearization (`blockform.linearize_block` or
    `linearize_block_chunked`) under `store["linearization"]`; returns the
    function that unwraps both."""
    from intrinsic3d_torch.refine import blockform

    one, chunked = blockform.linearize_block, blockform.linearize_block_chunked

    def keep_one(params, asm):
        store.setdefault("linearization", (params, asm, 1))
        return one(params, asm)

    def keep_chunked(params, asm, num_chunks, *rest):
        store.setdefault("linearization", (params, asm, num_chunks))
        return chunked(params, asm, num_chunks, *rest)

    blockform.linearize_block, blockform.linearize_block_chunked = keep_one, keep_chunked

    def restore():
        blockform.linearize_block, blockform.linearize_block_chunked = one, chunked

    return restore


def path_inputs(params, asm, num_chunks: int) -> dict:
    """From a block linearization's point: the E_g kernel's inputs for its
    first frame chunk (`eg_rows`: (EgRowsInputs, chunk weights, first frame,
    coefficient dtype), float32 as the one-shot solve writes them) and the
    sampler's (`bicubic_rows`), as the eager E_g forward of that chunk hands
    them to K1a: the CPU path's call, which the card's block path replaced
    with the E_g kernel and the flat path still makes."""
    import torch

    from intrinsic3d_torch.refine import blockform, residuals

    sh, sha = asm.sdf_plan.apply(params.sdf), asm.alb_plan.apply(params.albedo)
    _, n, xs = blockform._chunk_xs(asm, num_chunks)[0]
    stacks, sh9, vpos, fid = blockform._eg_chunk_inputs(asm, sh, sha, xs["eg_w"], xs["bmap"], xs["fids"],
                                                        params.poses, params.intr, params.dist)
    out = {}
    restore = capture_first_call(residuals, "bicubic_rows", out)
    try:
        with torch.no_grad():
            residuals.eg_core(*(a.movedim(0, -1) for a in stacks), sh9.movedim(0, -1), vpos.movedim(0, -1), fid,
                              asm.images, asm.pyr_scale, asm.voxel_size, active=(xs["eg_w"] > 0).to(torch.float32))
    finally:
        restore()
    out["eg_rows"] = (blockform._eg_inputs(asm, sh, sha, params), asm.eg_w[:n].clone(), 0, torch.float32)
    return out


def sampler_figures(kernel: str, inputs) -> dict:
    """K1a (`bicubic_rows_fwd`), K1b (`bicubic_rows_fwdgrad`) or K2
    (`nearest_rows`) on `inputs`: held against its plain version (K1a's
    value and K1b's value, ddx and ddy finite and within rtol 1e-5 with atol
    1e-5 x max; K2 `torch.equal`), timed in a CUDA graph, from Python and
    L2-flushed, its bound and its active share."""
    import torch

    from intrinsic3d_torch.ops import bicubic, profile_sampler
    from intrinsic3d_torch.ops.roofline import bound, cold_ms, needed_bytes

    images, fid, a, b, active = inputs
    m = active.shape[0]
    n_act = int((active > 0).sum())
    entry = profile_sampler.entry_launcher(kernel)
    got = entry(*inputs)
    if kernel == "nearest_rows":
        plain = lambda: bicubic.nearest_rows_plain(images, fid, a, b, active)  # noqa: E731
        want = plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"{kernel} differs from its plain version")
        abs_err = 0.0
    else:
        plain = lambda: bicubic.bicubic_rows_plain(images, fid, a, b, active)  # noqa: E731
        want = plain()
        pairs = list(zip(got, want)) if kernel == "bicubic_rows_fwdgrad" else [(got, want[0])]
        torch.cuda.synchronize()
        for g, w in pairs:
            if not torch.isfinite(g).all():
                fail(f"{kernel}: non-finite output")
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))
        abs_err = max(float((g - w).abs().max()) for g, w in pairs)
    b_ms, b_by = bound(needed_bytes(images, m, n_act, profile_sampler.OUT_BYTES[kernel]),
                       n_act * profile_sampler.OPS[kernel])
    kernel_fn = lambda: entry(*inputs)  # noqa: E731
    rec = dict(elements=m, active=n_act, active_share=n_act / max(m, 1), max_abs_err=abs_err,
               ms=graph_ms(kernel_fn), call_ms=cuda_ms(kernel_fn), cold_ms=cold_ms(kernel_fn),
               plain_ms=graph_ms(plain, 20 if m < 2**25 else 3), bound_ms=b_ms, bound_by=b_by)
    rec["pct_of_bound"] = 100 * b_ms / rec["cold_ms"]
    return rec


def sampler_line(rec: dict) -> str:
    return (f"M={rec['elements']} active={rec['active']} ({100 * rec['active_share']:.1f}%) "
            f"max_abs_err={rec['max_abs_err']:.3e} ms={rec['ms']:.4f} call_ms={rec['call_ms']:.4f} "
            f"cold_ms={rec['cold_ms']:.4f} plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
            f"({rec['bound_by']}) pct_of_bound={rec['pct_of_bound']:.1f}")


# float operations per active E_g element, counted from csrc/eg_rows.cu: the
# four points' geometry (~60 each), their samples (K1a's or K1b's,
# roofline.BICUBIC_OPS), the shading (~25 each) and residual (~15), and in
# the linearization the reverse pass (~150 a point)
EG_OPS = {"eg_rows_lin": 4 * (60 + 84 + 25 + 150) + 15, "eg_rows_value": 4 * (60 + 60 + 25) + 15}
# the kernel against the float64 evaluation of its plain version: within
# tests/test_torch_kernels.py's bound (twice the plain float32 version's own
# error on its scene) or twice the plain float32 version's own error on the
# same row, whichever is larger (the refinement's levels are conditioned
# otherwise than the test's scene)
EG_REL = 2e-4


def eg_figures(kernel: str, inputs) -> dict:
    """The E_g kernel's linearization (`eg_rows_lin`, in the coefficient
    dtype of `inputs`) or value mode (`eg_rows_value`) on `inputs` = (x,
    chunk weights, first frame, coefficient dtype): its frame row with the
    most nonzero residuals held against `eg_rows_plain` evaluated in float64
    (field by field within EG_REL x the field's largest magnitude or twice
    the plain float32 evaluation's own error, whichever is larger; bfloat16
    fields besides within one ulp),
    timed in a CUDA graph, from Python and L2-flushed, beside its byte bound:
    every element's flag and outputs, the per-slot stencil, SH and position
    values of the distinct slots the active elements read, the bucket rows,
    and the image stack once; and its active share."""
    import torch

    from intrinsic3d_torch.ops import eg_rows
    from intrinsic3d_torch.ops.roofline import bound, cold_ms

    x, eg_w, lo, dt = inputs
    x = eg_rows.EgRowsInputs(*(t.cuda() if torch.is_tensor(t) else t for t in x))
    eg_w = eg_w.cuda()
    n, kb, s = eg_w.shape
    k, m = x.poses.shape[0], eg_w.numel()
    e = (eg_w.reshape(-1) > 0).nonzero()[:, 0]
    n_act = int(e.numel())
    blk = (e // s) % kb
    if x.bmap is not None:
        blk = x.bmap[lo + e // (kb * s), blk]
    n_slots = int(torch.unique(blk * s + e % s).numel())
    if kernel == "eg_rows_lin":
        r0 = torch.empty((k, kb, s), device="cuda")
        coeffs = [torch.empty((f, k, kb, s), device="cuda", dtype=dt) for f in eg_rows.FIELDS]
        fn = lambda: eg_rows.eg_rows_lin(x, eg_w, lo, r0, coeffs)  # noqa: E731
        fn()
        res = r0[lo:lo + n]
        out_bytes = 4 + 29 * torch.tensor([], dtype=dt).element_size()
    else:
        fn = lambda: eg_rows.eg_rows_value(x, eg_w, lo)  # noqa: E731
        res = fn()[0]
        out_bytes = 4 + 4 / (4 * 256)
    row = int(torch.argmax((res != 0).sum(dim=(1, 2))))
    got_r = res[row]
    got_c = None
    if kernel == "eg_rows_lin":
        got_c = torch.cat([c[:, lo + row].reshape(c.shape[0], -1).double() for c in coeffs])
    x64 = eg_rows.EgRowsInputs(*(t.double() if torch.is_tensor(t) and t.is_floating_point() else t for t in x))
    want_r, want_c = eg_rows.eg_rows_plain(x64, eg_w[row:row + 1].double(), lo + row, lin=kernel == "eg_rows_lin")
    p32_r, p32_c = eg_rows.eg_rows_plain(x, eg_w[row:row + 1], lo + row, lin=kernel == "eg_rows_lin")
    torch.cuda.synchronize()
    errs, plain_errs = [], []
    pairs = [("residual", got_r.reshape(-1).double(), want_r, p32_r, False)]
    if got_c is not None:  # field by field, as tests/test_torch_kernels.py compares
        at = 0
        for name, f in zip(("sdf", "albedo", "pose", "intrinsics", "distortion"), eg_rows.FIELDS):
            pairs.append((name, got_c[at:at + f], want_c[at:at + f], p32_c[at:at + f], dt == torch.bfloat16))
            at += f
    for name, got, want, plain, bf16 in pairs:
        if not torch.isfinite(got).all():
            fail(f"{kernel}: non-finite output")
        top = max(float(want.abs().max()), 1e-30)
        plain_err = float((plain.double() - want).abs().max())
        slack = max(EG_REL * top, 2 * plain_err)
        if bf16:
            slack = slack + torch.pow(2.0, torch.floor(torch.log2(torch.clamp(want.abs(), min=2.0**-126))) - 7)
        err = float((got - want).abs().max())
        if not bool(((got - want).abs() <= slack).all()):
            fail(f"{kernel} {name} differs from the float64 plain version by {err:.3e} (field max {top:.3e}, "
                 f"the plain float32 version by {plain_err:.3e})")
        errs.append(err / top)
        plain_errs.append(plain_err / top)
    nbytes = (m * (4 + out_bytes) + n_slots * 26 * 4 + (0 if x.bmap is None else x.bmap.numel() * 8)
              + x.images.numel() * 4)
    b_ms, b_by = bound(nbytes, n_act * EG_OPS[kernel])
    rec = dict(elements=m, active=n_act, active_share=n_act / max(m, 1), slots=n_slots, frames=n,
               coeff_dtype=str(dt).replace("torch.", "") if kernel == "eg_rows_lin" else None,
               max_rel_err=max(errs), plain32_rel_err=max(plain_errs), needed_bytes=nbytes, ms=graph_ms(fn),
               call_ms=cuda_ms(fn), cold_ms=cold_ms(fn), bound_ms=b_ms, bound_by=b_by)
    rec["pct_of_bound"] = 100 * b_ms / rec["cold_ms"]
    return rec


def eg_line(rec: dict) -> str:
    return (f"M={rec['elements']} active={rec['active']} ({100 * rec['active_share']:.2f}%) slots={rec['slots']} "
            f"coeffs={rec['coeff_dtype']} max_rel_err={rec['max_rel_err']:.3e} (plain float32 "
            f"{rec['plain32_rel_err']:.3e}) ms={rec['ms']:.4f} "
            f"call_ms={rec['call_ms']:.4f} cold_ms={rec['cold_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
            f"({rec['bound_by']}, {rec['needed_bytes'] / 1e6:.1f} MB) pct_of_bound={rec['pct_of_bound']:.1f}")


def check_upsample(parents: list) -> dict:
    """The upsample kernel (`ops.upsample.upsample_fields`) on each parent
    grid a grid-level boundary of the pipeline refinement handed
    `grid.algorithms.upsample`: its child fields bit for bit those of its
    plain version on the card (`upsample_fields_plain`) and of the host path
    (`_upsample_fields` and the reorder into key order); the kernel timed in
    a CUDA graph, from Python and L2-flushed beside its byte bound (each
    byte the function needs read or written once: the order and channels
    of every child, the corner row and channels of every parent); the
    plain version's ms from Python; and the wall ms of the card's whole step
    (upload, launch, copy back, as `upsample` takes it) and of the host
    path's, medians of 5 after one untimed call. Returns the finest
    boundary's record with every boundary's figures under `boundaries`."""
    import numpy as np
    import torch

    from intrinsic3d_torch.grid import algorithms as alg
    from intrinsic3d_torch.ops.roofline import bound, cold_ms
    from intrinsic3d_torch.ops.upsample import FIELDS, upsample_fields, upsample_fields_plain

    def wall_ms(fn, reps: int = 5) -> float:
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])

    def bits(a):
        return np.ascontiguousarray(a).view(np.int32)

    out = []
    for g in parents:
        idx, _, order = alg._upsample_skeleton(g)
        names = FIELDS if g.is_sbr else FIELDS[:3]

        def upload():
            def put(a, dtype):
                return torch.as_tensor(np.ascontiguousarray(a, dtype), device="cuda")

            return {k: put(getattr(g, k), np.float32) for k in names}, put(idx, np.int32), put(order, np.int32)

        def host():
            return {k: v[order].astype(np.float32, copy=False) for k, v in alg._upsample_fields(g, idx=idx).items()}

        args = upload()
        got = {k: v.cpu().numpy() for k, v in upsample_fields(*args).items()}
        plain = {k: v.cpu().numpy() for k, v in upsample_fields_plain(*args).items()}
        want = host()
        for k in names:
            if not (np.array_equal(bits(got[k]), bits(plain[k])) and np.array_equal(bits(got[k]), bits(want[k]))):
                fail(f"upsample_fields ({g.num_voxels} parents): {k} differs from its plain version "
                     f"({np.array_equal(bits(got[k]), bits(plain[k]))} equal) or the host path "
                     f"({np.array_equal(bits(got[k]), bits(want[k]))} equal)")
        n, channels = g.num_voxels, 2 + 3 + 2 * g.is_sbr
        nbytes = 8 * n * (4 + 4 * channels) + n * (4 * 8 + 4 * channels)
        b_ms, b_by = bound(nbytes, 0)
        kernel = lambda: upsample_fields(*args)  # noqa: E731
        rec = dict(parents=n, children=8 * n, bitwise=True, bytes=nbytes, ms=graph_ms(kernel),
                   call_ms=cuda_ms(kernel), cold_ms=cold_ms(kernel),
                   plain_ms=cuda_ms(lambda: upsample_fields_plain(*args), 3), bound_ms=b_ms, bound_by=b_by,
                   card_step_ms=wall_ms(lambda: {k: v.cpu() for k, v in upsample_fields(*upload()).items()}),
                   host_ms=wall_ms(host))
        rec["pct_of_bound"] = 100 * b_ms / rec["cold_ms"]
        log(f"  upsample_fields: parents={n} children={8 * n} bitwise to the plain version and the host path; "
            f"ms={rec['ms']:.4f} call_ms={rec['call_ms']:.4f} cold_ms={rec['cold_ms']:.4f} "
            f"plain_ms={rec['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}) pct_of_bound={rec['pct_of_bound']:.1f}; "
            f"step on the card {rec['card_step_ms']:.2f} ms (upload, launch, copy back) against the host's "
            f"{rec['host_ms']:.1f} ms")
        out.append(rec)
        del args
    if not out:
        fail("the pipeline refinement handed upsample no grid")
    return dict(name="upsample_fields", route="cuda", source="intrinsic3d_torch/csrc/upsample_fields.cu",
                replaces="none (host numpy)", **out[-1], library_ms=None, boundaries=out)


def check_level_static(grids: list) -> dict:
    """The level-statics kernel (`ops.level_static.level_static`) on the
    grid of each of the pipeline refinement's grid levels (the parents the
    boundaries handed `upsample`, then the refined grid), with random
    per-voxel SH: the statics `build_level_static` builds on the card bit
    for bit those of the host build (`level_static_host` with the SH, from
    the grid's stencil tables); the kernel timed in a CUDA graph, from
    Python and L2-flushed beside its byte bound (each byte the function
    needs read or written once: the voxels' slot, sdf, weight, colour and
    SH, the block tables, and the six statics); and the wall ms of the
    card's whole build (upload, memset and launches, as `build_level_static`
    takes it) and of the host's (the statics, and the stencil tables they
    read), medians of 5 after one untimed call. Returns the finest level's
    record with every level's figures under `levels`."""
    import numpy as np
    import torch

    from intrinsic3d_torch.grid.blocks import BlockLayout
    from intrinsic3d_torch.ops.level_static import inputs_of, level_static
    from intrinsic3d_torch.ops.roofline import bound, cold_ms
    from intrinsic3d_torch.refine.assembly import LevelTopology
    from intrinsic3d_torch.refine.device_assembly import build_level_static, level_static_host

    def wall_ms(fn, reps: int = 5) -> float:
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])

    def bits(a):
        return np.ascontiguousarray(a.cpu().numpy() if torch.is_tensor(a) else a).view(np.int32)

    out = []
    for g in grids:
        layout = BlockLayout.build(g)
        sh = np.random.default_rng(g.num_voxels).normal(size=(g.num_voxels, 9)).astype(np.float32)
        topo = LevelTopology.build(g)
        host = level_static_host(layout, g, topo, sh)
        card = build_level_static(layout, g, None, sh, device="cuda")
        for field, a, b in zip(card._fields, card, host):
            if not np.array_equal(bits(a), bits(b)):
                fail(f"level_static ({g.num_voxels} voxels): {field} differs from the host build")
        args = [torch.as_tensor(a, device="cuda") for a in inputs_of(layout, g, sh)]
        n, nb, slots = g.num_voxels, layout.num_blocks, layout.num_blocks * layout.block**3
        # inputs: slot, sdf, weight, colour and SH a voxel, nbr27 and the
        # coordinates a block; outputs: occ and valid with their pad row,
        # and vpos, es_ref, eg_sh and ea_chroma a slot
        nbytes = (n * (8 + 4 + 4 + 12 + 36) + nb * (27 * 4 + 3 * 8) + 2 * 4 * (slots + layout.block**3)
                  + slots * 4 * (3 + 1 + 9 + 3))
        b_ms, b_by = bound(nbytes, 0)
        kernel = lambda: level_static(*args, layout.block)  # noqa: E731
        rec = dict(voxels=n, blocks=nb, bitwise=True, bytes=nbytes, ms=graph_ms(kernel), call_ms=cuda_ms(kernel),
                   cold_ms=cold_ms(kernel), bound_ms=b_ms, bound_by=b_by,
                   card_step_ms=wall_ms(lambda: build_level_static(layout, g, None, sh, device="cuda")),
                   host_ms=wall_ms(lambda: level_static_host(layout, g, topo, sh)),
                   topology_ms=wall_ms(lambda: LevelTopology.build(g), 1))
        rec["pct_of_bound"] = 100 * b_ms / rec["cold_ms"]
        log(f"  level_static: voxels={n} blocks={nb} bitwise to the host build; ms={rec['ms']:.4f} "
            f"call_ms={rec['call_ms']:.4f} cold_ms={rec['cold_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}, "
            f"{nbytes / 1e6:.1f} MB) pct_of_bound={rec['pct_of_bound']:.1f}; build on the card "
            f"{rec['card_step_ms']:.2f} ms (upload, memset, launches) against the host's {rec['host_ms']:.1f} ms "
            f"and its stencil tables' {rec['topology_ms']:.1f} ms")
        out.append(rec)
        del args, card
    if not out:
        fail("the pipeline refinement left no grid level")
    return dict(name="level_static", route="cuda", source="intrinsic3d_torch/csrc/level_static.cu",
                replaces="none (host numpy)", **out[-1], library_ms=None, levels=out)


def check_kernels(captured: dict) -> list:
    """Phase 1: each kernel against its plain version on the path's inputs
    (K1a and K1b on those the eager E_g forward of the path's first
    linearized chunk hands the sampler, `path_inputs`)."""
    import torch

    from intrinsic3d_torch.ops import bicubic

    records = []
    rows_inputs = captured["bicubic_rows"]
    rec = sampler_figures("bicubic_rows_fwdgrad", rows_inputs)
    # the wrapper's autograd rule: a unit cotangent gives back K1b's own
    # derivatives, bit for bit
    images, fid, x, y, active = rows_inputs
    xg, yg = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    out = bicubic.bicubic_rows(images, fid, xg, yg, active)
    grads = torch.autograd.grad(out, (xg, yg), grad_outputs=torch.ones_like(out))
    if not all(torch.equal(a, b) for a, b in zip((out.detach(), *grads),
                                                  bicubic._launch_bicubic(images, fid, x, y, active, True))):
        fail("bicubic_rows' autograd differs from the K1b kernel's outputs")
    log(f"  bicubic_rows_fwdgrad: {sampler_line(rec)}")
    records.append(dict(name="bicubic_rows_fwdgrad", route="cuda", source="intrinsic3d_torch/csrc/bicubic_rows.cu",
                        replaces="intrinsic3d_tpu/ops/pallas/bicubic.py:490", **rec, library_ms=None))

    rec = sampler_figures("bicubic_rows_fwd", rows_inputs)
    log(f"  bicubic_rows_fwd: {sampler_line(rec)}")
    records.append(dict(name="bicubic_rows_fwd", route="cuda", source="intrinsic3d_torch/csrc/bicubic_rows.cu",
                        replaces="intrinsic3d_tpu/ops/pallas/bicubic.py:473", **rec, library_ms=None))

    depths, fid, yi, xi, active = captured["nearest_rows"]
    rec = sampler_figures("nearest_rows", captured["nearest_rows"])
    # the yardstick: PyTorch's advanced-index gather (int32 indices), masked
    lib = lambda: depths[fid, yi, xi] * (active > 0)  # noqa: E731
    if not torch.equal(lib(), bicubic.nearest_rows_plain(depths, fid, yi, xi, active)):
        fail("nearest_rows yardstick differs")
    rec["library_ms"] = graph_ms(lib)
    log(f"  nearest_rows: {sampler_line(rec)} library_ms={rec['library_ms']:.4f}")
    records.append(dict(name="nearest_rows", route="cuda", source="intrinsic3d_torch/csrc/nearest_rows.cu",
                        replaces="intrinsic3d_tpu/ops/pallas/bicubic.py:690", **rec))

    if "eg_rows" in captured:  # a block path's (the flat path has no E_g kernel)
        rec = eg_figures("eg_rows_lin", captured["eg_rows"])
        log(f"  eg_rows_lin: {eg_line(rec)}")
        rec["value"] = eg_figures("eg_rows_value", captured["eg_rows"])
        log(f"  eg_rows_value: {eg_line(rec['value'])}")
        records.append(dict(name="eg_rows_lin", route="cuda", source="intrinsic3d_torch/csrc/eg_rows.cu",
                            replaces="none (XLA fuses the JAX package's eg_core forward and its vjp)", **rec,
                            library_ms=None))
    return records


def small_problem_agrees() -> None:
    """Phase 4: two chained outer steps on a small problem, on the card and
    through the plain CPU path, at converged-solve settings."""
    import torch

    from intrinsic3d_torch.synthetic import build_sphere_problem

    traj = {}
    for device in ("cuda", "cpu"):
        prob = build_sphere_problem(
            voxel_size=0.02, image_size=(64, 48), num_frames=2, num_observations=2,
            perturb_sdf=0.002, perturb_albedo=0.05, device=device,
        )
        level = prob.level()
        p, mu, costs = level.params, torch.tensor(0.3, device=device), []
        for _ in range(2):
            p, c0, c1, mu, tries = level.outer_step(
                p, prob.depths, prob.images, mu, lm_steps=3, cg_iters=200, cg_eta=1e-8,
                schur_globals=True, cg_coeff_dtype="float32",
            )
            costs.append((float(c0), float(c1), tries))
        traj[device] = costs
    log(f"  small problem: cuda {traj['cuda']} cpu {traj['cpu']}")
    for (a0, a1, at), (b0, b1, bt) in zip(traj["cuda"], traj["cpu"]):
        if at != bt or abs(a0 - b0) > 1e-3 * abs(b0) or abs(a1 - b1) > 1e-3 * abs(b1):
            fail(f"small-problem trajectory on the card {traj['cuda']} differs from the CPU path {traj['cpu']}")


def check_sampler_sample(rows_inputs) -> list:
    """The masked sampler's second entry, `bicubic_sample` (K4a forward,
    K4b backward; on no path), against its plain version's value and
    autograd gradient, on the refinement path's sampler inputs."""
    import torch

    from intrinsic3d_torch.ops import bicubic
    from intrinsic3d_torch.ops.roofline import BICUBIC_OPS, bound, cold_ms, needed_bytes

    images, fid, x, y, active = rows_inputs
    m = x.shape[0]
    n_act = int((active > 0).sum())
    gen = torch.Generator(device=x.device).manual_seed(7)
    g = torch.randn(m, generator=gen, device=x.device)
    xk, yk = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    out = bicubic.bicubic_sample(images, fid, xk, yk, active)
    gx, gy = torch.autograd.grad(out, (xk, yk), grad_outputs=g)
    xp, yp = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    want = bicubic.bicubic_sample_plain(images, fid, xp, yp, active)
    wx, wy = torch.autograd.grad(want, (xp, yp), grad_outputs=g)
    want = want.detach()
    torch.cuda.synchronize()
    records = []
    for tag, pairs in (("fwd", [(out.detach(), want)]), ("bwd", [(gx, wx), (gy, wy)])):
        for got, ref in pairs:
            if not torch.isfinite(got).all():
                fail(f"bicubic_sample_{tag}: non-finite output")
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
        abs_err = max(float((a - b).abs().max()) for a, b in pairs)
        if tag == "fwd":
            kernel = lambda: bicubic._launch_bicubic(  # noqa: E731
                images, fid, x, y, active, False, counter="bicubic_sample_fwd")
            plain = lambda: bicubic.bicubic_sample_plain(images, fid, x, y, active)  # noqa: E731
            nbytes = needed_bytes(images, m, n_act, 4)
        else:
            kernel = lambda: bicubic._launch_bicubic_bwd(images, fid, x, y, active, g)  # noqa: E731

            def plain():
                xq, yq = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
                return torch.autograd.grad(bicubic.bicubic_sample_plain(images, fid, xq, yq, active), (xq, yq), g)

            nbytes = needed_bytes(images, m, n_act, 8, act_in_bytes=16)
        ms, call_ms, l2_cold_ms = graph_ms(kernel), cuda_ms(kernel), cold_ms(kernel)
        plain_ms = cuda_ms(plain)
        b_ms, b_by = bound(nbytes, n_act * BICUBIC_OPS[tag])
        log(f"  bicubic_sample_{tag}: M={m} active={n_act} max_abs_err={abs_err:.3e} ms={ms:.4f} "
            f"call_ms={call_ms:.4f} cold_ms={l2_cold_ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}); "
            f"on no path")
        records.append(dict(
            name=f"bicubic_sample_{tag}", route="cuda", source="intrinsic3d_torch/csrc/bicubic_rows.cu",
            replaces="intrinsic3d_tpu/ops/pallas/bicubic.py:" + ("189" if tag == "fwd" else "214"),
            max_abs_err=abs_err, ms=ms, call_ms=call_ms, cold_ms=l2_cold_ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, on_path=False,
        ))
    return records


def sphere_band_field(shape, voxel: float, seed: int):
    """A dense sphere SDF truncated at 5 voxels plus seeded noise, made on
    the card: weight > 0 in the band and 0 elsewhere, so the sweeps have
    work."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    ax = [(torch.arange(n, device=dev, dtype=torch.float32) - 0.5 * n) * voxel for n in shape]
    r = 0.35 * min(shape) * voxel
    true = torch.sqrt(ax[0][:, None, None] ** 2 + ax[1][None, :, None] ** 2 + ax[2][None, None, :] ** 2) - r
    band = true.abs() < 5 * voxel
    noise = torch.randn(shape, generator=gen, device=dev) * (0.5 * voxel)
    sdf = torch.where(band, true + noise, torch.zeros_like(true))
    weight = torch.where(band, 0.5 + 2.5 * torch.rand(shape, generator=gen, device=dev), torch.zeros_like(true))
    return sdf.contiguous(), weight.contiguous()


def check_distance_transform(window_inputs) -> dict:
    """K3 against its plain version on the fusion path's dense window and on
    the DT_FIELD sphere band: the same sdf bit for bit and the same weight.
    Returns the record at the path's window, with the field's numbers under
    `field`."""
    import torch

    from intrinsic3d_torch.ops import build
    from intrinsic3d_torch.ops import distance_transform as dt
    from intrinsic3d_torch.ops.roofline import bound, cold_ms

    sdf, weight, voxel, iters = window_inputs
    out = {}
    for tag, (s_in, w_in, vs) in (("window", (sdf, weight, voxel)),
                                  ("field", (*sphere_band_field(DT_FIELD, 0.004, 11), 0.004))):
        plan = dt.sweep_plan(s_in.shape, iters)
        build.reset_launches()
        got_s, got_w = dt.correct_sdf_dense(s_in, w_in, vs, iters)
        launches = build.LAUNCHES["correct_sdf_dense"]
        if not 0 < launches == len(plan.sweeps) < iters:
            fail(f"correct_sdf_dense ({tag}) launched {launches} times, not the {len(plan.sweeps)} of its plan "
                 f"for {iters} sweeps")
        want_s, want_w = dt.correct_sdf_dense_plain(s_in, w_in, vs, iters)
        torch.cuda.synchronize()
        err = float((got_s - want_s).abs().max())
        if not (torch.equal(got_s.view(torch.int32), want_s.view(torch.int32)) and torch.equal(got_w, want_w)):
            fail(f"correct_sdf_dense ({tag}) differs from its plain version: max sdf err {err:.3e}, "
                 f"weights equal {torch.equal(got_w, want_w)}")
        changed = int((got_s != s_in).sum())
        n = s_in.numel()
        n_valid = int((w_in > 0).sum())
        kernel = lambda: dt._run_plan(s_in, w_in, vs, plan)  # noqa: E731
        reps = 20 if tag == "window" else 5
        ms, call_ms, l2_cold_ms = graph_ms(kernel, reps), cuda_ms(kernel, reps), cold_ms(kernel, reps)
        plain_ms = cuda_ms(lambda: dt.correct_sdf_dense_plain(s_in, w_in, vs, iters), 3)
        b_ms, b_by = bound(16 * n, iters * 26 * DT_OPS_PER_NEIGHBOUR * n_valid)
        log(f"  correct_sdf_dense ({tag}): dims={tuple(s_in.shape)} voxels={n} valid={n_valid} "
            f"changed={changed} iters={iters} launches_per_call={launches} (counted) "
            f"plan: sweeps_per_launch={list(plan.sweeps)} tile={plan.tile_y}x{plan.tile_z(plan.sweeps[0])}x{plan.seg} "
            f"cols={plan.cols} threads={plan.threads(plan.sweeps[0])} "
            f"blocks={plan.blocks(s_in.shape)}; max_abs_err={err:.3e} ms={ms:.4f} call_ms={call_ms:.4f} "
            f"cold_ms={l2_cold_ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"pct_of_bound={100 * b_ms / l2_cold_ms:.1f} (of the L2-flushed time)")
        out[tag] = dict(dims=list(s_in.shape), max_abs_err=err, ms=ms, call_ms=call_ms, cold_ms=l2_cold_ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, pct_of_bound=100 * b_ms / l2_cold_ms,
                        launches_per_call=launches)
        del got_s, got_w, want_s, want_w
    rec = dict(name="correct_sdf_dense", route="cuda", source="intrinsic3d_torch/csrc/correct_sdf_dense.cu",
               replaces="intrinsic3d_tpu/ops/pallas/distance_transform.py:179", library_ms=None,
               **{k: v for k, v in out["window"].items() if k != "dims"})
    rec["field"] = out["field"]
    return rec


def fused_sdf_error(grid, center, radius: float):
    """Median and p90 of |fused − analytic sdf| on seen voxels with
    |analytic| < truncation/2 (the bar of tests/test_grid.py), and their count."""
    import numpy as np

    true = np.linalg.norm(grid.voxel_to_world() - np.asarray(center), axis=-1) - radius
    near = (grid.weight > 0) & (np.abs(true) < grid.truncation * 0.5)
    err = np.abs(grid.sdf[near] - true[near])
    return float(np.median(err)), float(np.percentile(err, 90)), int(near.sum())


def fusion_phase() -> dict:
    """Stages 1 and 2 of bench_pipeline.py on the card: a warm-up run that
    records the dense distance-transform kernel's inputs, then the run read
    for launches and times. Returns the launches, the K3 window inputs, and
    what stage 3 starts from: the fused grid, the sensor, the keyframe ids
    and the sensor's initial poses and camera."""
    import torch

    from intrinsic3d_torch.apps import app_fusion, app_keyframes
    from intrinsic3d_torch.grid import algorithms
    from intrinsic3d_torch.ops import build
    from intrinsic3d_torch.synthetic import PIPELINE_DATASET, PIPELINE_SETTINGS, build_orbit_dataset, pipeline_configs

    t0 = time.perf_counter()
    sensor = build_orbit_dataset(**PIPELINE_DATASET)
    dataset_s = time.perf_counter() - t0
    initial = ([sensor.pose(i).copy() for i in range(sensor.num_frames)], sensor.color_cam)
    center, radius = PIPELINE_DATASET["center"], PIPELINE_DATASET["radius"]
    kcfg, fcfg = pipeline_configs(center=center, radius=radius, **PIPELINE_SETTINGS)

    captured = {}
    restore = capture_first_call(algorithms, "correct_sdf_dense", captured)
    app_keyframes.run(sensor, kcfg)
    app_fusion.run(sensor, fcfg)
    torch.cuda.synchronize()
    restore()
    if "correct_sdf_dense" not in captured:
        fail("the fusion warm-up did not take the dense distance-transform route")

    build.reset_launches()
    t0 = time.perf_counter()
    sel = app_keyframes.run(sensor, kcfg)
    torch.cuda.synchronize()
    keyframes_s = time.perf_counter() - t0
    stats = {}
    t0 = time.perf_counter()
    grid = app_fusion.run(sensor, fcfg, stats=stats)
    fusion_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    win = captured["correct_sdf_dense"]
    log(f"phase fusion: frames={sensor.num_frames} {sensor.depth_cam.width}x{sensor.depth_cam.height} "
        f"keyframes selected {sel.count()} {sel.keyframe_ids()}; dataset {dataset_s:.2f}s (host), "
        f"keyframes {keyframes_s:.4f}s, fusion {fusion_s:.4f}s")
    log("  fusion sub-phases (s): " + " ".join(f"{k}={stats[k]:.4f}" for k in app_fusion.PHASES))
    log(f"  bitmap dims {stats['dims']} ({int(torch.tensor(stats['dims']).prod())} voxels), allocated "
        f"{stats['allocated']}, kept {stats['kept']}, K3 window dims {tuple(win[0].shape)}, "
        f"launches {launches}")
    from intrinsic3d_torch.ops import distance_transform as dt

    planned = len(dt.sweep_plan(win[0].shape, win[3]).sweeps)
    if not 0 < launches["correct_sdf_dense"] == planned < win[3]:
        fail(f"the fusion path launched the distance-transform kernel {launches['correct_sdf_dense']} times, "
             f"not the {planned} of its plan for {win[3]} sweeps")
    med, p90, n_near = fused_sdf_error(grid, center, radius)
    log(f"  fused sdf vs the analytic sphere on {n_near} near-surface voxels: median {med:.6f} m, "
        f"p90 {p90:.6f} m (bar: < {fcfg.voxel_size} m, < {2.5 * fcfg.voxel_size} m)")
    if not (n_near > 1000 and med < fcfg.voxel_size and p90 < 2.5 * fcfg.voxel_size):
        fail("the fused SDF misses the analytic sphere's bar")
    return dict(launches=launches, window=win, grid=grid, sensor=sensor, keyframes=sel.keyframe_ids(),
                initial=initial)


def small_fusion_agrees() -> None:
    """A small fusion problem (4 orbit frames, 64x48, clip bounds) on the
    card (dense route, K3) and on the CPU (the gather table): the same voxel
    set, sdf within 1e-6, weight rtol 1e-5, color within 1e-3."""
    import numpy as np

    from intrinsic3d_torch.apps import app_fusion
    from intrinsic3d_torch.synthetic import DEFAULT_CENTER, build_orbit_dataset, pipeline_configs

    sensor = build_orbit_dataset(4, 64, 48, center=DEFAULT_CENTER, radius=0.12)
    _, cfg = pipeline_configs(center=DEFAULT_CENTER, radius=0.12)
    card = app_fusion.run(sensor, cfg, device="cuda")
    cpu = app_fusion.run(sensor, cfg, device="cpu")
    if card.num_voxels < 500 or not np.array_equal(card.coords, cpu.coords):
        fail(f"small fusion: voxel sets differ ({card.num_voxels} on the card, {cpu.num_voxels} on the CPU)")
    errs = (float(np.abs(card.sdf - cpu.sdf).max()),
            float(np.abs(card.weight - cpu.weight).max() / np.abs(cpu.weight).max()),
            float(np.abs(card.color - cpu.color).max()))
    log(f"  small fusion: {card.num_voxels} voxels on both; max |d sdf| {errs[0]:.3e}, "
        f"max |d weight|/max weight {errs[1]:.3e}, max |d color| {errs[2]:.3e}")
    if errs[0] > 1e-6 or errs[1] > 1e-5 or errs[2] > 1e-3:
        fail("small fusion: the card's fields differ from the CPU path's")


PIPELINE_SCHEDULE = [(2, 2), (2, 1), (2, 0), (1, 0), (0, 0)]


def run_refinement(tag: str, sensor, keyframes, initial, fused, capture_levels: bool = False,
                   capture_samplers: bool = False, prefetch: bool = True) -> dict:
    """`Intrinsic3D.refine` of `fused` on the card (stage 3 of
    bench_pipeline.py: 3 grid levels × 3 pyramid levels, 10 outer iterations
    each) from the sensor's `initial` poses and camera, with the level
    pipeline on or off (`prefetch`) and the launch counters zeroed just
    before and read just after. Prints each level's size, plan, iteration
    times, costs, tries, mu and peak memory, and the phase seconds; writes
    them to chiprun_out/<tag>_levels.json. With `capture_levels`, every
    level's `optimize_level` arguments are kept under `inputs` (the grid
    copied, the rest references; `prep=None` in place of the level's
    consumed `LevelPrep`, so a replay builds its level serially). With
    `capture_samplers`, a host copy of the inputs of each level's first E_g
    kernel call of each mode and first K2 call inside `optimize_level` is
    kept under `sampler_calls`,
    one dict a level, with the level's launches of every kernel (`launches`)
    and the copy's seconds (`capture_s`, inside `total_s`; the levels' peak
    memory holds none of it), and a copy of the parent grid each grid-level
    boundary hands `upsample` under `boundaries` (its seconds in
    `capture_s` too)."""
    import torch

    from intrinsic3d_torch import observations
    from intrinsic3d_torch.grid import algorithms as alg
    from intrinsic3d_torch.ops import build, eg_rows
    from intrinsic3d_torch.refine import intrinsic3d
    from intrinsic3d_torch.synthetic import PIPELINE_CG_ITERS, PIPELINE_REFINEMENT

    poses, cam = initial
    for i, pose in enumerate(poses):
        sensor.set_pose(i, pose)
    sensor.color_cam = cam
    levels, stats, inputs, sampler_calls, boundaries, boundary_s = [], {}, [], [], [], []
    real, real_upsample = intrinsic3d.optimize_level, alg.upsample

    def keep_inputs(grid, *args, **kw):
        # `refine` writes the refined fields and colours back into the
        # level's grid afterwards: keep the grid the level started from,
        # once the level's prep thread (which memoizes the grid's topology
        # on it) has ended
        if capture_levels:
            if kw.get("prep") is not None:
                kw["prep"].join()
            inputs.append(((copy.deepcopy(grid), *args), dict(kw, prep=None)))
        if not capture_samplers:
            return real(grid, *args, **kw)
        calls, before = {}, dict(build.LAUNCHES)
        sampler_calls.append(calls)
        restore = [capture_first_call(eg_rows, "eg_rows_lin", calls, to_host=True,
                                      pick=lambda args: (*args[:3], args[4][0].dtype)),
                   capture_first_call(eg_rows, "eg_rows_value", calls, to_host=True,
                                      pick=lambda args: (*args[:3], None)),
                   capture_first_call(observations, "nearest_rows", calls, to_host=True)]
        try:
            return real(grid, *args, **kw)
        finally:
            for r in restore:
                r()
            calls["launches"] = {k: build.LAUNCHES[k] - before[k] for k in build.LAUNCHES}

    def keep_boundary(grid, *args, **kw):
        t0 = time.perf_counter()
        boundaries.append(grid.clone())
        boundary_s.append(time.perf_counter() - t0)
        return real_upsample(grid, *args, **kw)

    if capture_levels or capture_samplers:
        intrinsic3d.optimize_level = keep_inputs
    if capture_samplers:
        alg.upsample = keep_boundary
    try:
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        engine = intrinsic3d.Intrinsic3D(PIPELINE_REFINEMENT, sensor, keyframes, cg_iters=PIPELINE_CG_ITERS,
                                         stats=stats, prefetch=prefetch)
        engine.add_callback(lambda info: levels.append((info.grid_level, info.pyramid_level, info.grid.num_voxels,
                                                        info.stats)))
        refined = engine.refine(fused, stats=stats)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    finally:
        intrinsic3d.optimize_level, alg.upsample = real, real_upsample

    capture_s = sum(calls.get("capture_s", 0.0) for calls in sampler_calls) + sum(boundary_s)
    log(f"phase {tag} (level pipeline {'on' if prefetch else 'off'}): {len(keyframes)} keyframes, fused "
        f"{fused.num_voxels} voxels -> refined "
        f"{refined.num_voxels} voxels at {refined.voxel_size * 1e3:.3f} mm; total {total_s:.3f}s"
        + (f" ({capture_s:.3f}s of it the host copies of the sampler inputs and boundary grids)"
           if capture_samplers else ""))
    records = []
    for g, p, nvox, st in levels:
        per_el = st.peak_bytes / st.elements
        log(f"  level g{g}p{p}: voxels={nvox} blocks={st.num_blocks} bucket_blocks={st.bucket_blocks}/"
            f"{st.num_blocks} elements={st.elements} plan '{st.reason}' eg_chunks={st.eg_chunks}; setup "
            f"{st.setup_seconds:.3f}s, outer iteration median {statistics.median(st.iter_seconds):.4f}s "
            f"(min {min(st.iter_seconds):.4f}, max {max(st.iter_seconds):.4f}); cost {st.costs_before[0]:.6f} -> "
            f"{st.costs_after[-1]:.6f}; tries {st.tries}; mu {st.mus[-1]:.3e}; peak memory "
            f"{st.peak_bytes / 1e9:.3f} GB = {per_el:.1f} B/element")
        records.append(dict(level=f"g{g}p{p}", voxels=nvox, blocks=st.num_blocks, bucket_blocks=st.bucket_blocks,
                            eg_chunks=st.eg_chunks, elements=st.elements, reason=st.reason,
                            setup_s=st.setup_seconds, prefetch_s=st.prefetch_seconds, iter_s=st.iter_seconds,
                            costs_before=st.costs_before,
                            costs_after=st.costs_after, tries=st.tries, mu=st.mus[-1], peak_bytes=st.peak_bytes,
                            bytes_per_element=per_el))
    log("  refinement phases (s): " + " ".join(f"{k}={v:.4f}" for k, v in stats.items()))
    log(f"  launches {launches}")
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / f"{tag}_levels.json").write_text(json.dumps(
        dict(total_s=total_s, prefetch=prefetch, phases=stats, levels=records, launches=launches), indent=1))
    return dict(launches=launches, levels=records, total_s=total_s, refined=refined, inputs=inputs, initial=initial,
                sampler_calls=sampler_calls, boundaries=boundaries, phases=stats, prefetch=prefetch)


def check_levels(run: dict) -> dict:
    """The E_g kernel (both modes) and K2 on the first inputs each level of
    the pipeline refinement handed them (`eg_figures`, `sampler_figures` on
    the card, each level's line printed): per kernel the list of level
    records, with the level's launches, and the main-path total: the sum
    over levels of launches at the level x L2-flushed ms."""
    import torch

    out = {}
    for kernel in BLOCK_PATH_KERNELS:
        recs, total, in_levels = [], 0.0, 0
        for lv, calls in zip(run["levels"], run["sampler_calls"]):
            if kernel not in calls:
                fail(f"level {lv['level']} made no {kernel} call inside optimize_level")
            inputs = tuple(a.cuda() if torch.is_tensor(a) else a for a in calls.pop(kernel))
            figures = eg_figures if kernel.startswith("eg_rows") else sampler_figures
            rec = dict(level=lv["level"], launches=calls["launches"][kernel], **figures(kernel, inputs))
            del inputs
            line = eg_line if kernel.startswith("eg_rows") else sampler_line
            log(f"  level {lv['level']} {kernel}: launches={rec['launches']} {line(rec)}")
            total += rec["launches"] * rec["cold_ms"]
            in_levels += rec["launches"]
            recs.append(rec)
        log(f"  {kernel} on the main path: {in_levels} launches inside the levels (of {run['launches'][kernel]} in "
            f"the refinement), sum of launches x L2-flushed ms {total:.4f} ms")
        out[kernel] = dict(levels=recs, main_path_ms=total, launches_in_levels=in_levels)
    return out


def level_starts_to_host(inputs) -> list:
    """`run_refinement`'s recorded `optimize_level` inputs with every tensor
    moved to the host (for the ranks): [(grid, params, depths, images,
    voxel_sh, thres_shell, rgbd_level, mu0)]."""
    out = []
    for args, kw in inputs:
        grid, _, params, _, _, depths, images, voxel_sh, thres_shell, rgbd_level = args
        out.append((grid, [t.cpu().numpy() for t in params], depths.cpu().numpy(), images.cpu().numpy(), voxel_sh,
                    thres_shell, rgbd_level, kw["mu0"]))
    return out


def multidevice_rank(mesh, fused, keyframes, starts) -> dict:
    """One rank of step 7b: `parallel.dryrun.refinement_task` (the
    two-rank refinement of `fused`, counters zeroed just before it and read
    just after, then `optimize_level(mesh=)` from each recorded start of
    the single-device run); rank 0 records the first linearization's and
    K2's inputs in the refinement (`path_inputs`, which every rank calls:
    the E_g kernel's and K1's) and holds the kernels against their plain
    versions on them afterwards."""
    import torch

    from intrinsic3d_torch import observations
    from intrinsic3d_torch.parallel import dryrun

    torch.backends.cuda.matmul.allow_tf32 = False
    captured = {}
    restore = [capture_linearization(captured)]
    if mesh.rank == 0:
        restore.append(capture_first_call(observations, "nearest_rows", captured))
    try:
        out = dryrun.refinement_task(mesh, fused, keyframes, starts)
    finally:
        for r in restore:
            r()
    # on every rank: the halo'd stencil shifts of `path_inputs` are collectives
    captured.update(path_inputs(*captured.pop("linearization")))
    if mesh.rank == 0:
        out["kernels"] = check_kernels(captured)
    return out


def single_device_sensitivity(fusion: dict, single: dict, noise: float = 1e-7) -> list:
    """Step 7's refinement again with `noise` (Gaussian, seeded) added to
    the colour frames: the relative gap of each level's first cost to step
    7's, printed — how far rounding-sized input changes move the
    single-device trajectory itself."""
    import numpy as np

    from intrinsic3d_torch.io.memory_sensor import MemorySensor

    sensor = fusion["sensor"]
    rng = np.random.default_rng(7)
    n = sensor.num_frames
    colors = [np.clip(np.asarray(sensor.color(i)) + rng.normal(0.0, noise, np.shape(sensor.color(i))), 0.0, 1.0)
              .astype(np.float32) for i in range(n)]
    noisy = MemorySensor(sensor.color_cam, sensor.depth_cam, colors, [sensor.depth(i) for i in range(n)],
                         [sensor.pose(i) for i in range(n)], sensor.depth_min, sensor.depth_max)
    run = run_refinement("refinement_noise", noisy, fusion["keyframes"], fusion["initial"], fusion["grid"])
    gaps = [abs(a["costs_before"][0] - b["costs_before"][0]) / b["costs_before"][0]
            for a, b in zip(run["levels"], single["levels"])]
    log(f"  single-device against itself with {noise:g} colour noise: first-cost gaps per level "
        + " ".join(f"{lv['level']}={g:.2e}" for lv, g in zip(single["levels"], gaps)))
    return gaps


def multidevice_phase(fusion: dict, single: dict) -> dict:
    """Steps 7b-7d (module docstring). `single` is step 7's run with its
    recorded level starts. Returns the per-rank launches and rank 0's kernel
    records."""
    import numpy as np
    import torch

    from intrinsic3d_torch.parallel import dryrun

    g0 = [r for r in single["levels"] if r["level"] == "g0p0"][0]
    log(f"phase multidevice: 2 ranks on {torch.cuda.get_device_name(0)} over gloo; reckoning: the single-device "
        f"finest level peaked at {g0['peak_bytes'] / 1e9:.2f} GB for {g0['elements']} elements, so each rank "
        f"needs about {g0['peak_bytes'] / 2e9:.2f} GB plus the replicated images")
    starts = level_starts_to_host(single["inputs"])
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the ranks
    t0 = time.perf_counter()
    ranks = dryrun.launch(multidevice_rank, 2, backend="gloo", device="cuda",
                          args=(fusion["grid"], fusion["keyframes"], starts), timeout=900.0)
    wall = time.perf_counter() - t0
    del starts
    log(f"  two-rank refinement: {wall:.1f}s wall (spawn, dataset and the level-start runs included); refine "
        f"{[round(r['total_s'], 3) for r in ranks]} s per rank")
    for r in ranks:
        g0r = [lv for lv in r["levels"] if lv["level"] == "g0p0"][0]
        log(f"  rank {r['rank']}: finest level {g0r['blocks']} blocks, brick {g0r['brick_rows']} rows, halo rows "
            f"{g0r['halo_rows']} per mesh shift, {g0r['elements']} elements ({g0r['reason']}); peak memory "
            f"{max(lv['peak_bytes'] for lv in r['levels']) / 1e9:.3f} GB; outer iteration at g0 median "
            f"{statistics.median(g0r['iter_s']):.4f}s (min {min(g0r['iter_s']):.4f}, max {max(g0r['iter_s']):.4f}); "
            f"collectives {r['collectives']['total_calls']} calls in {r['collectives']['total_s']:.3f}s "
            f"{r['collectives']['calls']}; launches E_g {r['launches']['eg_rows_lin']} + "
            f"{r['launches']['eg_rows_value']} K2 {r['launches']['nearest_rows']}")
        for name in BLOCK_PATH_KERNELS:
            if r["launches"][name] == 0:
                fail(f"rank {r['rank']} never launched {name} in the multi-device refinement")
        for records in r["placements"]:
            for name, total, mine in records:
                if mine > total / 2 + 4096:
                    fail(f"rank {r['rank']} holds {mine} of {total} bytes of {name}")
    r0 = ranks[0]
    if [lv["level"] for lv in r0["levels"]] != [lv["level"] for lv in single["levels"]]:
        fail(f"multi-device schedule {[lv['level'] for lv in r0['levels']]} differs from the single-device one")
    for i, (lv, ref) in enumerate(zip(r0["levels"], single["levels"])):
        got, want = lv["costs_before"][0], ref["costs_before"][0]
        log(f"  level {lv['level']}: first cost {got:.6f} (single-device {want:.6f}, rel {abs(got - want) / want:.2e}); "
            f"last {lv['costs_after'][-1]:.6f} (single-device {ref['costs_after'][-1]:.6f}); tries {lv['tries']} "
            f"(single-device {ref['tries']}); iteration median {statistics.median(lv['iter_s']):.4f}s "
            f"(single-device {statistics.median(ref['iter_s']):.4f}s)")
        # the first level starts from the same inputs as step 7's: gated; the
        # later ones start where each run's own trajectory ended, which
        # rounding moves as far as the single-device run's own gaps below
        # show, so they are gated from the same start instead (next)
        if i == 0 and not np.isclose(got, want, rtol=1e-3, atol=0.0):
            fail(f"level {lv['level']}: first cost {got} not within rtol 1e-3 of the single-device {want}")
        for it, (c0, c1) in enumerate(zip(lv["costs_before"], lv["costs_after"])):
            if not (np.isfinite(c0) and np.isfinite(c1)) or c1 > c0:
                fail(f"multi-device level {lv['level']} iteration {it}: accepted cost {c1} against {c0}")
    # from each level's recorded start the two ranks run the loop that
    # `Intrinsic3D(mesh=)` runs (`optimize_level(mesh=)`): its first cost and
    # its first sharded GN step (halo'd stencils, all-reduced PCG and
    # globals) against the single device's
    for got, ref in zip(r0["from_starts"], single["levels"]):
        for key in ("costs_before", "costs_after"):
            g, want = got[key][0], ref[key][0]
            log(f"  level {ref['level']} from the single-device run's start, 2 ranks: {key}[0] {g:.7f} "
                f"(single-device {want:.7f}, rel {abs(g - want) / want:.2e}); costs {got['costs_before']} -> "
                f"{got['costs_after']} tries {got['tries']}")
            if not np.isclose(g, want, rtol=1e-3, atol=0.0):
                fail(f"level {ref['level']} from its recorded start: {key}[0] {g} not within rtol 1e-3 of the "
                     f"single-device {want}")
    sdf = r0["sdf"]
    log(f"  refined sdf vs the analytic sphere on {sdf['shell_voxels']} shell voxels: median {sdf['median']:.6f} m, "
        f"p90 {sdf['p90']:.6f} m; unrefined median {sdf['unrefined_median']:.6f} m (bar: median < "
        f"{r0['voxel_size']} m and <= 1.1 x unrefined)")
    if not (sdf["shell_voxels"] > 1000 and sdf["median"] < r0["voxel_size"]
            and sdf["median"] <= 1.1 * sdf["unrefined_median"]):
        fail("the multi-device refined SDF misses the analytic sphere's bar")
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "multidevice_levels.json").write_text(json.dumps(
        dict(wall_s=wall, ranks=[{k: v for k, v in r.items() if k != "kernels"} for r in ranks]), indent=1))
    single_device_sensitivity(fusion, single)

    t0 = time.perf_counter()
    for line in dryrun.launch(dryrun.dryrun_rank, 4, backend="gloo", device="cuda", timeout=600.0)[0]:
        log(f"  {line}")
    log(f"  dry run at 4 ranks over gloo on the card: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    lp = dryrun.level_inputs(dryrun.small_problem())
    runs = dryrun.launch(dryrun.pipeline_task, 1, backend="nccl", device="cuda", args=(lp,), timeout=300.0)[0]
    for mode, r in runs.items():
        got, want = r["mesh"], r["single"]
        log(f"  one rank over nccl, optimize_level[{mode}]: costs {got['costs_before']} -> {got['costs_after']} "
            f"(mesh=None {want['costs_before']} -> {want['costs_after']})")
        if not (np.allclose(got["costs_before"], want["costs_before"], rtol=1e-4, atol=0.0)
                and np.allclose(got["costs_after"], want["costs_after"], rtol=1e-3, atol=0.0)):
            fail(f"optimize_level(mesh=) over nccl [{mode}] differs from mesh=None")
    log(f"  one rank over nccl: {time.perf_counter() - t0:.1f}s")
    return dict(launches=[r["launches"] for r in ranks], kernels=r0["kernels"])


def pose_drift(poses, keyframes, initial) -> str:
    """How far the refined keyframe poses moved from the initial (true)
    ones: median and largest camera-centre shift and rotation. `poses` and
    `initial` are camera-to-world matrices indexed by frame."""
    import numpy as np

    shift, angle = [], []
    for i in keyframes:
        a, b = np.asarray(initial[i]), np.asarray(poses[i])
        shift.append(float(np.linalg.norm(a[:3, 3] - b[:3, 3])))
        cos = (np.trace(a[:3, :3].T @ b[:3, :3]) - 1.0) / 2.0
        angle.append(float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))))
    return (f"poses moved from the initial ones by median {np.median(shift) * 1e3:.3f} mm, max "
            f"{max(shift) * 1e3:.3f} mm and median {np.median(angle):.4f} deg, max {max(angle):.4f} deg (printed, "
            f"not checked)")


def check_refinement(run: dict, sensor, keyframes, dataset: dict) -> None:
    """The bars every pipeline refinement meets: the schedule, no accepted
    cost rising, finite fields and poses, 1 mm at the end, the E_g and
    depth-probe kernels launched, the upsample kernel once a grid-level
    boundary, and the refined SDF against the analytic sphere."""
    import numpy as np

    refined, records = run["refined"], run["levels"]
    schedule = [tuple(int(c) for c in r["level"][1:].split("p")) for r in records]
    if schedule != PIPELINE_SCHEDULE:
        fail(f"refinement schedule {schedule}, expected {PIPELINE_SCHEDULE}")
    for r in records:
        for it, (c0, c1) in enumerate(zip(r["costs_before"], r["costs_after"])):
            if not (np.isfinite(c0) and np.isfinite(c1)) or c1 > c0:
                fail(f"level {r['level']} iteration {it}: accepted cost {c1} against {c0}")
    fields = (refined.sdf_refined, refined.albedo, refined.color, refined.sdf, refined.weight)
    if not all(np.isfinite(f).all() for f in fields):
        fail("non-finite refined fields")
    if not all(np.isfinite(sensor.pose(i)).all() for i in keyframes):
        fail("non-finite refined poses")
    if abs(refined.voxel_size - 0.001) > 1e-9:
        fail(f"final voxel size {refined.voxel_size}, expected 0.001 m")
    for name in BLOCK_PATH_KERNELS:
        if run["launches"][name] == 0:
            fail(f"kernel {name} was never launched in the pipeline refinement")
    n_boundaries = len({g for g, _ in schedule}) - 1
    if run["launches"]["upsample_fields"] != n_boundaries:
        fail(f"the upsample kernel launched {run['launches']['upsample_fields']} times for {n_boundaries} grid-level "
             f"boundaries")
    if run["launches"]["level_static"] != len(schedule):
        fail(f"the level-statics kernel launched {run['launches']['level_static']} times for {len(schedule)} levels")
    from intrinsic3d_torch.synthetic import refined_sdf_error

    med, p90, med0, n_shell = refined_sdf_error(refined, dataset["center"], dataset["radius"])
    log(f"  refined sdf vs the analytic sphere on {n_shell} shell voxels: median {med:.6f} m, p90 {p90:.6f} m; "
        f"unrefined median {med0:.6f} m (bar: median < {refined.voxel_size} m and <= 1.1 x unrefined)")
    if not (n_shell > 1000 and med < refined.voxel_size and med <= 1.1 * med0):
        fail("the refined SDF misses the analytic sphere's bar")
    refined_poses = [sensor.pose(i) for i in range(sensor.num_frames)]
    log(f"  {pose_drift(refined_poses, keyframes, run['initial'][0])}")


def refinement_phase(fusion: dict) -> dict:
    """Stage 3 of bench_pipeline.py on the card from the 30-frame fused grid
    (`run_refinement`): fails unless `check_refinement`'s bars hold and every
    level plans dense, and holds the E_g kernel and K2 against their plain
    versions on each level's first inputs (`check_levels`). Returns the
    launches, the per-level records, the levels' recorded `optimize_level`
    inputs (`inputs`), the per-level sampler records (`sampler_levels`) and
    the upsample kernel's record (`upsample`, `check_upsample`) and the
    level-statics kernel's (`level_static`, `check_level_static`)."""
    from intrinsic3d_torch.synthetic import PIPELINE_DATASET

    run = run_refinement("refinement", fusion["sensor"], fusion["keyframes"], fusion["initial"], fusion["grid"],
                         capture_levels=True, capture_samplers=True)
    for r in run["levels"]:
        if not r["reason"].startswith("dense"):
            fail(f"level {r['level']} was planned '{r['reason']}', not dense")
    check_refinement(run, fusion["sensor"], fusion["keyframes"], PIPELINE_DATASET)
    run["sampler_levels"] = check_levels(run)
    parents = run.pop("boundaries")
    run["upsample"] = check_upsample(parents)
    run["level_static"] = check_level_static(parents + [run["refined"]])
    del run["sampler_calls"]
    return run


# the phase kinds the level pipeline moves, as the engine names them
PIPELINE_PHASE_KINDS = ("level_setup", "prefetch", "topology", "svsh", "solve", "upsample", "upsample_prep",
                        "sparsify", "recolor", "initial_recolor", "pyramids")
PREFETCH_AB = (False, True, True, False)
# the first level starts from the same grid in every run, but its colors and
# lighting come from the card's atomic sums: two runs of one setting were
# 1.07e-6 apart on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6, the level
# pipeline), so the bar sits at ten times that and the gaps are printed
FIRST_COST_RTOL = 1e-5


def prefetch_phase(fusion: dict, main: dict) -> dict:
    """The pipeline refinement of step 7 again with the level pipeline off
    and on (`Intrinsic3D(prefetch=)`), four uncaptured runs in the order
    off, on, on, off in this call. Prints every run's wall clock and its
    phases summed by kind (the preps' own thread seconds under `prefetch`
    and `upsample_prep`), every phase by name beside its counterpart, and
    each level's median outer iteration (the solve's, which a background
    thread holding the GIL would slow: the convoy effect). Fails unless
    every run meets `check_refinement`'s bars, every level's plan, bucket
    blocks and chunks equal step 7's, and the first level's first
    cost is within `FIRST_COST_RTOL` of step 7's (the same grid; the
    largest gaps between runs of one setting and between the settings are
    printed). Writes chiprun_out/prefetch_ab.json."""
    import numpy as np

    from intrinsic3d_torch.synthetic import PIPELINE_DATASET

    runs = []
    for i, prefetch in enumerate(PREFETCH_AB):
        run = run_refinement(f"refinement_prefetch_{'on' if prefetch else 'off'}_{i}", fusion["sensor"],
                             fusion["keyframes"], fusion["initial"], fusion["grid"], prefetch=prefetch)
        check_refinement(run, fusion["sensor"], fusion["keyframes"], PIPELINE_DATASET)
        # the later levels' voxel sets follow each run's own trajectory (the
        # card's atomic sums), so their block counts may differ by a few
        for lv, ref in zip(run["levels"], main["levels"]):
            got = (lv["level"], lv["reason"], lv["bucket_blocks"], lv["eg_chunks"])
            want = (ref["level"], ref["reason"], ref["bucket_blocks"], ref["eg_chunks"])
            if got != want:
                fail(f"run {i} (prefetch {prefetch}) planned {got} where step 7 planned {want}")
        got, want = run["levels"][0]["costs_before"][0], main["levels"][0]["costs_before"][0]
        if not np.isclose(got, want, rtol=FIRST_COST_RTOL, atol=0.0):
            fail(f"run {i} (prefetch {prefetch}): first cost {got} not within rtol {FIRST_COST_RTOL:g} of step 7's "
                 f"{want}")
        kinds = {k: 0.0 for k in PIPELINE_PHASE_KINDS}
        for name, sec in run["phases"].items():
            kinds[name.split("[")[0]] = kinds.get(name.split("[")[0], 0.0) + sec
        runs.append(dict(prefetch=prefetch, total_s=run["total_s"], phases=run["phases"], kinds=kinds,
                         medians={lv["level"]: statistics.median(lv["iter_s"]) for lv in run["levels"]},
                         first_cost=got))
        del run
    log("  level pipeline A/B (off, on, on, off; host wall clock, no synchronize at a phase's end; "
        "prefetch and upsample_prep are the threads' own seconds, overlapped):")
    for r in runs:
        log(f"    prefetch {'on ' if r['prefetch'] else 'off'}: refinement {r['total_s']:.4f}s; "
            + " ".join(f"{k}={v:.4f}" for k, v in r["kinds"].items()))
    names = list(dict.fromkeys(n for r in runs for n in r["phases"]))
    for name in names:
        cells = " / ".join("-" if name not in r["phases"] else f"{r['phases'][name]:.4f}" for r in runs)
        log(f"    {name}: {cells}")
    for level in runs[0]["medians"]:
        off = [r["medians"][level] for r in runs if not r["prefetch"]]
        on = [r["medians"][level] for r in runs if r["prefetch"]]
        log(f"    {level} median outer iteration: off {' / '.join(f'{m:.4f}' for m in off)} s, on "
            f"{' / '.join(f'{m:.4f}' for m in on)} s (on / off {sum(on) / sum(off):.3f})")
    firsts = [(True, main["levels"][0]["costs_before"][0])] + [(r["prefetch"], r["first_cost"]) for r in runs]

    def gap(pairs):
        return max((abs(a - b) / abs(b) for a, b in pairs), default=0.0)

    same = gap((a, b) for i, (pa, a) in enumerate(firsts) for pb, b in firsts[i + 1:] if pa == pb)
    cross = gap((a, b) for i, (pa, a) in enumerate(firsts) for pb, b in firsts[i + 1:] if pa != pb)
    log(f"  first level's first cost: step 7 {firsts[0][1]:.7f}, runs " + " / ".join(f"{c:.7f}" for _, c in firsts[1:])
        + f"; largest gap between runs of one setting {same:.2e}, between the settings {cross:.2e} (bar "
        f"{FIRST_COST_RTOL:g} to step 7's)")
    on_s = [r["total_s"] for r in runs if r["prefetch"]]
    off_s = [r["total_s"] for r in runs if not r["prefetch"]]
    log(f"  level pipeline: refinement on {' / '.join(f'{t:.4f}' for t in on_s)} s against off "
        f"{' / '.join(f'{t:.4f}' for t in off_s)} s (mean on / off {sum(on_s) / sum(off_s):.3f}); plans and first "
        f"costs equal to step 7's")
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "prefetch_ab.json").write_text(json.dumps(dict(order=list(PREFETCH_AB), runs=runs),
                                                                      indent=1))
    return dict(runs=runs)


def exact_bucket_blocks(inputs) -> int:
    """The width of a level's exact frame buckets (`plan_eg_layout` with
    bucketing forced and no budget) from its recorded `optimize_level`
    inputs."""
    import dataclasses

    import numpy as np

    from intrinsic3d_torch.grid.blocks import BlockLayout
    from intrinsic3d_torch.mathutil import pyramid_level_to_scale
    from intrinsic3d_torch.refine import optimizer as opt

    (grid, _, params, cfg, _, depths, _, _, thres, rgbd), _ = inputs
    fb, _, _ = opt.plan_eg_layout(
        BlockLayout.build(grid), params.poses.cpu().numpy(),
        params.intr.cpu().numpy().astype(np.float64) * pyramid_level_to_scale(rgbd),
        dataclasses.replace(cfg, frame_bucketing="always"), int(depths.shape[2]), int(depths.shape[1]),
        grid.voxel_size, thres, depths.cpu().numpy() if cfg.occlusion_distance > 0.0 else None,
        budget=float("inf"),
    )
    return int(fb.shape[1])


def streaming_budget(k: int, bucket_blocks: int, chunks: int) -> float:
    """A budget under which `plan_eg_layout` streams `k` frames of exact
    buckets `bucket_blocks` wide in `chunks` frame chunks (its memory model
    solved for ⌈k/chunks⌉ frames a chunk)."""
    from intrinsic3d_torch.refine import optimizer as opt

    el_frame = bucket_blocks * 512
    frames = -(-k // chunks) + 0.5
    return k * el_frame * opt._EG_CHUNK_PERSIST_BYTES + frames * el_frame * opt._EG_CHUNK_TRANSIENT_BYTES


def stream_arithmetic(k: int, bucket_blocks: int, budget: float) -> str:
    """The planner's streaming arithmetic for exact buckets, as text, and
    whether one-frame chunks fit the budget."""
    from intrinsic3d_torch.refine import optimizer as opt

    el = k * bucket_blocks * 512
    persist, assembly = el * opt._EG_CHUNK_PERSIST_BYTES, el * opt._EG_ASSEMBLY_BYTES
    per_frame = bucket_blocks * 512 * opt._EG_CHUNK_TRANSIENT_BYTES
    f_max = int((budget - persist) // per_frame) if persist < budget else 0
    fits = persist < budget and assembly <= budget and f_max >= 1
    return (f"{el} exact elements: one-shot {el * opt._EG_DENSE_BYTES_PER_ELEMENT / 1e9:.2f} GB, persistent "
            f"{persist / 1e9:.2f} GB + {per_frame / 1e9:.3f} GB a chunk frame, assembly {assembly / 1e9:.2f} GB, "
            f"budget {budget / 1e9:.2f} GB: up to {f_max} frames a chunk; one-frame chunks "
            f"{'fit' if fits else 'do not fit'}"), fits


def compare_levels(tag: str, inputs, runs: dict, coeff_dtype: str, gate: bool, capture: dict = None) -> None:
    """Two outer iterations of a level from its recorded `optimize_level`
    inputs, once per entry of `runs` ({name: (config changes, budget,
    expected chunks)}), each from the same start, with the E_g coefficients
    in `coeff_dtype`; the first run's sampler inputs are captured into
    `capture` when given. Fails unless each run's plan is bucketed in the
    expected chunks and, when `gate`, the second run's first cost agrees
    with the first run's at rtol 1e-4 and its trajectory at rtol 2e-2
    (tests/test_eg_chunked.py's tolerances); otherwise the differences are
    only printed."""
    import dataclasses

    import numpy as np
    import torch

    from intrinsic3d_torch import observations
    from intrinsic3d_torch.refine import optimizer as opt

    args, kw = inputs
    kw = dict(kw, cg_coeff_dtype=coeff_dtype)
    out = {}
    for i, (name, (changes, budget, chunks)) in enumerate(runs.items()):
        cfg = dataclasses.replace(args[3], iterations=2, **changes)
        restore = []
        if capture is not None and i == 0:
            restore = [capture_linearization(capture), capture_first_call(observations, "nearest_rows", capture)]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            _, _, st = opt.optimize_level(*args[:3], cfg, *args[4:], **kw, budget=budget)
        finally:
            for r in restore:
                r()
        if "linearization" in (capture or {}):
            capture.update(path_inputs(*capture.pop("linearization")))
        out[name] = st
        held = sum(a.numel() * a.element_size() for v in (capture or {}).values() if isinstance(v, tuple)
               for a in v if torch.is_tensor(a))
        log(f"  {tag}, {coeff_dtype} coefficients, {name}: plan '{st.reason}' eg_chunks={st.eg_chunks} "
            f"bucket_blocks={st.bucket_blocks} elements={st.elements}; costs {st.costs_before} -> {st.costs_after}; "
            f"tries {st.tries}; peak {st.peak_bytes / 1e9:.3f} GB = {st.peak_bytes / st.elements:.1f} B/element"
            + (f" (with the {held / 1e9:.3f} GB of captured sampler inputs)" if restore else "")
            + f"; {time.perf_counter() - t0:.2f}s")
        if st.eg_chunks != chunks or st.bucket_blocks == 0:
            fail(f"{tag} {name}: planned '{st.reason}' in {st.eg_chunks} chunks, expected bucketed in {chunks}")
    (a, sa), (b, sb) = out.items()
    first = abs(sb.costs_before[0] - sa.costs_before[0]) / abs(sa.costs_before[0])
    traj = max(abs(y - x) / abs(x) for x, y in zip(sa.costs_before + sa.costs_after, sb.costs_before + sb.costs_after))
    log(f"  {tag}, {coeff_dtype}: {b} against {a}: first cost {first:.2e} apart, trajectory {traj:.2e} at most"
        + (" (bars 1e-4, 2e-2)" if gate else " (reported)"))
    if gate and not (first <= 1e-4 and np.allclose(sb.costs_before + sb.costs_after, sa.costs_before + sa.costs_after,
                                                     rtol=2e-2, atol=0)):
        fail(f"{tag}: the {b} run's costs do not track the {a} run's")


def many_keyframe_phase() -> dict:
    """bench_pipeline.py --frames 90 on the card: the orbit with 90 frames,
    keyframes (30 kept) and fusion, then the refinement of `run_refinement`
    from the initial poses, its counters zeroed just before and read just
    after. Fails unless `check_refinement`'s bars hold, the finest level is
    frame-bucketed by the planner's own rules, and no level is frame-capped
    unless one-frame chunks of its exact buckets cannot fit. Then the
    streamed check (`compare_levels`): at the 2 mm level, the bucketed level
    one-shot (no budget) against streamed in 2 chunks; at the finest level
    (whose exact buckets do not fit one-shot on an 80 GB card), the
    planner's own plan against twice its chunks, the sampler inputs of its
    first run captured. Returns the launches, the
    records and the captured inputs."""
    import torch

    from intrinsic3d_torch.apps import app_fusion, app_keyframes
    from intrinsic3d_torch.refine import optimizer as opt
    from intrinsic3d_torch.synthetic import (
        PIPELINE_MANY_KF_DATASET,
        PIPELINE_SETTINGS,
        build_orbit_dataset,
        pipeline_configs,
    )

    ds = PIPELINE_MANY_KF_DATASET
    t0 = time.perf_counter()
    sensor = build_orbit_dataset(**ds)
    dataset_s = time.perf_counter() - t0
    initial = ([sensor.pose(i).copy() for i in range(sensor.num_frames)], sensor.color_cam)
    kcfg, fcfg = pipeline_configs(center=ds["center"], radius=ds["radius"], **PIPELINE_SETTINGS)
    t0 = time.perf_counter()
    keyframes = app_keyframes.run(sensor, kcfg).keyframe_ids()
    torch.cuda.synchronize()
    keyframes_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused = app_fusion.run(sensor, fcfg)
    fusion_s = time.perf_counter() - t0
    budget = opt.eg_hbm_budget()
    log(f"phase many-keyframe fusion: frames={sensor.num_frames} {sensor.depth_cam.width}x"
        f"{sensor.depth_cam.height}, {len(keyframes)} keyframes; dataset {dataset_s:.2f}s (host), keyframes "
        f"{keyframes_s:.4f}s, fusion {fusion_s:.4f}s, {fused.num_voxels} voxels; E_g budget {budget / 1e9:.2f} GB")
    if len(keyframes) != ds["num_frames"] // PIPELINE_SETTINGS["window_size"]:
        fail(f"{len(keyframes)} keyframes of the {ds['num_frames']}-frame orbit")

    run = run_refinement("many_keyframe_refinement", sensor, keyframes, initial, fused, capture_levels=True)
    check_refinement(run, sensor, keyframes, ds)
    k = len(keyframes)
    for r, inputs in zip(run["levels"], run["inputs"]):
        if "frame-capped" in r["reason"] or r["bucket_blocks"]:
            text, fits = stream_arithmetic(k, exact_bucket_blocks(inputs), budget)
            log(f"  level {r['level']} '{r['reason']}': {text}")
            if "frame-capped" in r["reason"] and fits:
                fail(f"level {r['level']} was frame-capped where its exact buckets stream")
    finest = run["levels"][-1]
    if not finest["bucket_blocks"]:
        fail(f"the finest level was planned '{finest['reason']}', not frame-bucketed")
    n = run["launches"]
    log(f"  refinement {run['total_s']:.3f}s; launches eg_rows_lin={n['eg_rows_lin']} "
        f"eg_rows_value={n['eg_rows_value']} nearest_rows={n['nearest_rows']}")

    # --- the streamed check, each pair from one recorded start: gated with
    # float32 coefficients, where the streamed path computes what one-shot
    # does; reported with the production bfloat16 ones, where it takes the
    # gradient and diagonal from the cast fields (the JAX package's design)
    always = dict(frame_bucketing="always")
    mid = run["inputs"][-2]
    mid_pair = {
        "one-shot": (always, float("inf"), 1),
        "streamed": (always, streaming_budget(k, exact_bucket_blocks(mid), 2), 2),
    }
    c0 = finest["eg_chunks"]
    c1 = 2 * c0 if 2 * c0 <= k else c0 // 2
    finest_pair = {
        f"planned ({c0} chunks)": ({}, None, c0),
        f"{c1} chunks": ({}, streaming_budget(k, finest["bucket_blocks"], c1), c1),
    }
    captured = {}
    for dtype, gate in (("float32", True), ("bfloat16", False)):
        compare_levels("2 mm level", mid, mid_pair, dtype, gate)
        compare_levels("finest level", run["inputs"][-1], finest_pair, dtype, gate,
                       capture=captured if gate else None)
    del run["inputs"], mid
    return dict(launches=run["launches"], levels=run["levels"], total_s=run["total_s"], captured=captured)


def numpy_route_grid(grid):
    """`grid` with its neighbor tables built through the numpy route
    (`find_indices`) instead of the native library: the timing pair of
    `apps_phase`."""
    import dataclasses

    from intrinsic3d_torch.grid.voxel_grid import VoxelGrid, find_indices

    class NumpyGrid(VoxelGrid):
        def neighbor_table(self, offsets):
            return find_indices(self.keys, self.coords[:, None, :] + offsets[None, :, :])

    return NumpyGrid(**{f.name: getattr(grid, f.name) for f in dataclasses.fields(VoxelGrid)})


def topology_pair(grids: dict) -> dict:
    """Each grid level's `LevelTopology.build` through the native library and
    through the numpy route, back to back on the same grid; the tables must
    be equal. Seconds by level."""
    import numpy as np

    from intrinsic3d_torch.refine.assembly import LevelTopology

    out = {}
    for tag, grid in grids.items():
        t0 = time.perf_counter()
        native_topo = LevelTopology.build(grid)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        numpy_topo = LevelTopology.build(numpy_route_grid(grid))
        numpy_s = time.perf_counter() - t0
        for f in ("eg_sdf10_idx", "eg_alb4_idx", "ring6_idx", "nbr4_idx", "ea_pairs", "coords"):
            if not np.array_equal(getattr(native_topo, f), getattr(numpy_topo, f)):
                fail(f"topology {tag}: the native library's {f} differs from the numpy route's")
        out[tag] = dict(voxels=grid.num_voxels, native_s=native_s, numpy_s=numpy_s)
    return out


APP_STAGES = (("keyframes", "keyframes.yml"), ("fusion", "fusion.yml"), ("intrinsic3d", "intrinsic3d.yml"))


def apps_phase() -> dict:
    """The three command-line apps on the card at `GoldenSceneSpec.full_scale()`
    (30 frames at 640x480, 4 mm -> 1 mm over 3 grid and 3 RGB-D levels, 10
    iterations, 5 observations): the dataset is exported under build/, the
    counters zeroed, and each app's `main` run with its default device, the
    working directory restored between them. Then the files are checked
    against the in-process stages and the scene's analytic sphere and orbit.
    Returns the launches."""
    import os
    import shutil

    import numpy as np
    import torch

    from intrinsic3d_torch.apps import app_fusion, app_intrinsic3d, app_keyframes
    from intrinsic3d_torch.camera import Camera
    from intrinsic3d_torch.config import FusionConfig, KeyframesConfig, SensorConfig, Settings, resolve_relative
    from intrinsic3d_torch.grid.voxel_grid import VoxelGrid
    from intrinsic3d_torch.io.dataset import SensorI3D
    from intrinsic3d_torch.io.golden_dataset import GoldenSceneSpec, export_sphere_dataset
    from intrinsic3d_torch.io.ply import load_ply
    from intrinsic3d_torch.io.trajectory import load_poses
    from intrinsic3d_torch.keyframes import KeyframeSelection
    from intrinsic3d_torch.mesh.metrics import mesh_error_vs_analytic, sample_surface
    from intrinsic3d_torch.ops import build
    from intrinsic3d_torch.refine import intrinsic3d

    spec = GoldenSceneSpec.full_scale()
    root = REPO / "build" / "apps_full_scale"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    sensor_yml = export_sphere_dataset(str(root), spec)
    export_s = time.perf_counter() - t0
    apps = dict(keyframes=app_keyframes, fusion=app_fusion, intrinsic3d=app_intrinsic3d)

    # the grid of each grid level, coarsest first, as its lighting estimate
    # takes it (references only)
    level_grids, real_svsh = [], intrinsic3d.estimate_svsh

    def keep_grid(grid, *args, **kw):
        if not any(g is grid for g in level_grids):
            level_grids.append(grid)
        return real_svsh(grid, *args, **kw)

    cwd = os.getcwd()
    wall, stats = {}, {}
    intrinsic3d.estimate_svsh = keep_grid
    try:
        torch.cuda.synchronize()
        build.reset_launches()
        for stage, cfg in APP_STAGES:
            kw = dict(stats=stats) if stage == "intrinsic3d" else {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                rc = apps[stage].main(["-s", sensor_yml, "-c", str(root / cfg)], **kw)
            finally:
                os.chdir(cwd)
            torch.cuda.synchronize()
            wall[stage] = time.perf_counter() - t0
            if rc != 0:
                fail(f"app_{stage}.main returned {rc}")
        launches = dict(build.LAUNCHES)
    finally:
        intrinsic3d.estimate_svsh = real_svsh
    # the engine numbers its grid levels from the finest (0) up
    level_grids = {f"g{spec.grid_levels - 1 - i}": g for i, g in enumerate(level_grids)}

    exports_s = stats.get("exports", 0.0)
    log(f"phase apps: GoldenSceneSpec.full_scale() ({spec.num_frames} frames {spec.width}x{spec.height}, "
        f"{spec.voxel_size * 1e3:.0f} mm, {spec.grid_levels} grid x {spec.rgbd_levels} RGB-D levels, "
        f"{spec.iterations} iterations) exported in {export_s:.2f}s (host)")
    log("  app wall clock (s, device synchronized at each end): "
        + " ".join(f"{k}={v:.4f}" for k, v in wall.items()))
    log(f"  app_intrinsic3d: callback exports (meshes, PLY, poses, intrinsics) {exports_s:.4f}s, refinement "
        f"{wall['intrinsic3d'] - exports_s:.4f}s")
    log("  app_intrinsic3d phases (s): " + " ".join(f"{k}={v:.4f}" for k, v in stats.items()))
    log(f"  launches {launches}")
    for name in (*BLOCK_PATH_KERNELS, "correct_sdf_dense"):
        if launches[name] == 0:
            fail(f"kernel {name} was never launched by the apps")

    # keyframes.txt against the in-memory stage on the same sensor
    scfg = SensorConfig.from_settings(Settings.load(sensor_yml))
    sensor = SensorI3D(resolve_relative(sensor_yml, scfg.dataset), scfg)
    kcfg = KeyframesConfig.from_settings(Settings.load(str(root / "keyframes.yml")))
    written = KeyframeSelection.load(str(root / "fusion" / "keyframes.txt"))
    sel = app_keyframes.run(sensor, kcfg)
    if list(written.is_keyframe) != list(sel.is_keyframe) or sel.count() == 0:
        fail(f"keyframes.txt selects {written.keyframe_ids()}, app_keyframes.run {sel.keyframe_ids()}")

    # the .tsdf against the in-memory fusion of the same sensor
    fcfg = FusionConfig.from_settings(Settings.load(str(root / "fusion.yml")))
    fused = app_fusion.run(sensor, fcfg)
    loaded = VoxelGrid.load(str(root / "fusion" / "volume.tsdf"), sensor.depth_min, sensor.depth_max)
    same = (np.array_equal(loaded.coords, fused.coords) and np.array_equal(loaded.sdf, fused.sdf)
            and np.array_equal(loaded.weight, fused.weight)
            and np.array_equal(loaded.color, np.clip(fused.color, 0, 255).astype(np.uint8).astype(np.float32)))
    if not same or loaded.num_voxels < 1000:
        fail("the written .tsdf does not reload to the grid app_fusion.run returns")
    log(f"  keyframes.txt selects {sel.keyframe_ids()} as app_keyframes.run does; volume.tsdf reloads to "
        f"app_fusion.run's grid bit for bit ({loaded.num_voxels} voxels)")

    # every level's files
    levels = [(g, p) for g in range(spec.grid_levels - 1, -1, -1) for p in range(spec.rgbd_levels - 1, -1, -1)
              if p == 0 or g == spec.grid_levels - 1]
    out = root / "intrinsic3d"
    for g, p in levels:
        tag = f"g{g}_p{p}"
        for suffix in ("", "_albedo"):
            v, f, c = load_ply(str(out / f"mesh_{tag}{suffix}.ply"))
            if len(f) < 100 or c is None or not np.isfinite(v).all():
                fail(f"mesh_{tag}{suffix}.ply: {len(f)} faces, colors {c is not None}")
        poses, _ = load_poses(str(out / f"poses_{tag}.txt"))
        if len(poses) != spec.num_frames or not np.isfinite(np.stack(poses)).all():
            fail(f"poses_{tag}.txt: {len(poses)} poses")
        cam = Camera.load(str(out / f"intrinsics_{tag}.txt"))
        if (cam.width, cam.height) != (spec.width, spec.height) or not np.isfinite(cam.matrix()).all():
            fail(f"intrinsics_{tag}.txt: {cam}")
    log(f"  per-level files of {len(levels)} levels written and loaded: meshes (voxel colors, albedo), "
        f"{spec.num_frames} TUM poses, intrinsics")

    # the finest refined mesh against the analytic sphere
    center, radius = np.asarray(spec.center), spec.radius
    v, f, _ = load_ply(str(out / "mesh_g0_p0.ply"))
    sphere = lambda p: np.linalg.norm(p - center, axis=-1) - radius  # noqa: E731
    err = mesh_error_vs_analytic(v, f, sphere)
    median = float(np.median(np.abs(sphere(sample_surface(v, f, 50000, 0)))))
    finest = spec.voxel_size / 2 ** (spec.grid_levels - 1)
    log(f"  finest refined mesh ({len(v)} vertices, {len(f)} faces) vs the analytic sphere: median "
        f"{median * 1e3:.4f} mm, mean {err['mean'] * 1e3:.4f} mm, rms {err['rms'] * 1e3:.4f} mm, p95 "
        f"{err['p95'] * 1e3:.4f} mm, max {err['max'] * 1e3:.4f} mm (bar: median < {finest / 2 * 1e3:.2f} mm)")
    if not median < finest / 2:
        fail("the finest refined mesh misses the analytic sphere's bar")

    # refined keyframe centres against the orbit, and their drift
    poses, _ = load_poses(str(out / "poses_g0_p0.txt"))
    kf = written.keyframe_ids()
    true = [np.loadtxt(str(root / "rgbd" / f"frame-{i:06d}.pose.txt")) for i in range(spec.num_frames)]
    centre_err = [float(np.linalg.norm(poses[i][:3, 3] - true[i][:3, 3])) for i in kf]
    log(f"  refined keyframes {kf}: {pose_drift(poses, kf, true)}; largest centre error "
        f"{max(centre_err) * 1e3:.3f} mm (bar: < 200 mm)")
    if not max(centre_err) < 0.2:
        fail("a refined keyframe centre left the orbit by 0.2 m or more")

    topo = topology_pair(level_grids)
    log("  level topology (s), native library against the numpy route on the same grid: " + " ".join(
        f"{k}: {t['voxels']} voxels native {t['native_s']:.4f} numpy {t['numpy_s']:.4f}" for k, t in topo.items()))
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "apps.json").write_text(json.dumps(dict(
        export_s=export_s, wall_s=wall, exports_s=exports_s, phases=stats, launches=launches,
        mesh_error=dict(err, median=median), keyframes=kf, centre_err=centre_err, topology=topo), indent=1))
    return dict(launches=launches)


def _within(name: str, got, want, rtol: float, atol: float = 0.0) -> float:
    """Fail unless |got − want| ≤ atol + rtol·|want| elementwise; returns
    the largest |got − want|."""
    import torch

    got, want = torch.as_tensor(got, dtype=torch.float64), torch.as_tensor(want, dtype=torch.float64)
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or bool((err > atol + rtol * want.abs()).any()):
        fail(f"flat: {name} differs (max |d| {float(err.max()):.3e}, rtol {rtol}, atol {atol})")
    return float(err.max())


def float64_gradients(asm, basm, params, bparams, table) -> dict:
    """The flat and block gradients of the cost in float64 on the card:
    both problems cast, the sampler swapped for its plain version (the
    kernel takes float32), whose value carries the same derivatives as the
    kernel's autograd function. Returns {leaf: (flat, block)}, the block
    voxel leaves in table order."""
    import torch

    from intrinsic3d_torch.ops import bicubic
    from intrinsic3d_torch.refine import blockform, residuals

    def plain_rows(images, fid, x, y, active):
        val, ddx, ddy = bicubic.bicubic_rows_plain(images, fid, x.detach(), y.detach(), active)
        return val + ddx * (x - x.detach()) + ddy * (y - y.detach())

    def cast(tup):
        return type(tup)(*(v.to(torch.float64) if torch.is_tensor(v) and v.is_floating_point() else v for v in tup))

    def grad(fn, p):
        leaves = [v.detach().requires_grad_(True) for v in cast(p)]
        return torch.autograd.grad(fn(residuals.Params(*leaves)), leaves)

    a, b = cast(asm), cast(basm)
    orig, residuals.bicubic_rows = residuals.bicubic_rows, plain_rows
    try:
        g_t = grad(lambda p: residuals.total_cost(p, a), params)
        g_b = grad(lambda p: 0.5 * torch.sum(blockform.block_all_residuals(p, b, masked=False) ** 2), bparams)
    finally:
        residuals.bicubic_rows = orig
    out = {}
    for i, name in enumerate(residuals.Params._fields):
        out[name] = (g_t[i], table(g_b[i]) if name in ("sdf", "albedo") else g_b[i])
    return out


def flat_phase(prob, level, n_block_active: int) -> dict:
    """The flat-table oracle on the bench-scale problem on the card (the
    module docstring's step 5). Returns the flat outer step's launches,
    the step times, the flat active count and the kernel checks on the
    flat path's inputs."""
    import dataclasses

    import torch

    from intrinsic3d_torch import observations
    from intrinsic3d_torch.ops import build
    from intrinsic3d_torch.refine import blockform, residuals
    from intrinsic3d_torch.refine.optimizer import optimize_level
    from intrinsic3d_torch.refine.residuals import Params, total_cost
    from intrinsic3d_torch.refine.solver import gn_iteration
    from intrinsic3d_torch.synthetic import build_sphere_problem

    gn = dict(lm_steps=3, cg_iters=6)
    dev = prob.images.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def flat_outer():
        t0 = time.perf_counter()
        asm, masks = prob.assemble()
        sync()
        t1 = time.perf_counter()
        out = gn_iteration(prob.params, asm, masks, 1e-4, **gn, device=dev)
        sync()
        return asm, masks, out, t1 - t0, time.perf_counter() - t1

    # warm-up: the first autograd graphs of this path on the card, recording
    # the first inputs the flat path hands each kernel (the assembly's depth
    # probe and creation-time residual probe)
    captured = {}
    restore = [capture_first_call(residuals, "bicubic_rows", captured),
               capture_first_call(observations, "nearest_rows", captured)]
    try:
        flat_outer()
    finally:
        for r in restore:
            r()
    if set(captured) != {"bicubic_rows", "nearest_rows"}:
        fail(f"flat: the warm-up did not reach every kernel: {sorted(captured)}")
    build.reset_launches()
    asm, masks, (p_t, c0_t, c1_t, _, tries_t), asm_s, flat_gn_s = flat_outer()
    launches = dict(build.LAUNCHES)
    n_flat = int((asm.eg_w > 0).sum())
    log(f"  flat assembly: {asm.eg_w.shape[0]} elements, {n_flat} active (block assembly: {n_block_active} active "
        f"of {level.layout.num_blocks * 512 * prob.images.shape[0]} dense elements)")
    checks = check_kernels(captured)
    del captured

    bparams, basm, bmasks = blockform.to_block_problem(
        level.layout, prob.topo.coords, asm, masks, prob.params, device=dev
    )
    table = lambda f: blockform.dense_to_table(level.layout, f)  # noqa: E731

    def cost_grad(fn, params):
        leaves = [p.detach().requires_grad_(True) for p in params]
        cost = fn(Params(*leaves))
        return float(cost.detach()), Params(*torch.autograd.grad(cost, leaves))

    c_t, g_t = cost_grad(lambda p: total_cost(p, asm), prob.params)
    c_b, g_b = cost_grad(lambda p: 0.5 * torch.sum(blockform.block_all_residuals(p, basm, masked=False) ** 2), bparams)
    _within("cost", c_b, c_t, 1e-4)
    # gradients: rtol 2e-4 with an absolute floor of 2e-4 × the leaf's
    # largest magnitude (at least 1e-6). A voxel's gradient sums many
    # elements' terms, and on the card both sums are atomic scatter-adds in
    # different orders, so an element near 0 by cancellation sits in the
    # float32 rounding of its terms. The float64 reading below shows the two
    # paths compute the same gradient and how far each float32 one strays
    g64 = float64_gradients(asm, basm, prob.params, bparams, table)
    grads = []
    for name, got, want in (("sdf", table(g_b.sdf), g_t.sdf), ("albedo", table(g_b.albedo), g_t.albedo),
                            ("poses", g_b.poses, g_t.poses), ("intr", g_b.intr, g_t.intr),
                            ("dist", g_b.dist, g_t.dist)):
        floor = max(1e-6, 2e-4 * float(want.abs().max()))
        t64, b64 = g64[name]
        scale = max(float(t64.abs().max()), 1e-30)
        gap64 = _within(f"float64 gradient {name}", b64, t64, 0.0, 1e-9 * scale)
        err_t = float((want.double() - t64).abs().max())
        err_b = float((got.double() - b64).abs().max())
        grads.append(f"{name} {_within(f'gradient {name}', got, want, 2e-4, floor):.3e} (floor {floor:.3e}; "
                     f"float64 gap {gap64:.3e} at max |g| {scale:.4g}; float32 from float64: flat {err_t:.3e}, "
                     f"block {err_b:.3e})")
    del g64
    log(f"  flat against block: cost {c_t:.6f} / {c_b:.6f}, gradients max |d|: {'; '.join(grads)}")

    def block_gn():
        t0 = time.perf_counter()
        out = gn_iteration(bparams, basm, bmasks, 1e-4, **gn, cg_coeff_dtype="float32", device=dev)
        sync()
        return out, time.perf_counter() - t0

    block_gn()
    (p_b, c0_b, c1_b, _, tries_b), block_gn_s = block_gn()
    c0_t, c1_t, c0_b, c1_b = float(c0_t), float(c1_t), float(c0_b), float(c1_b)
    if c1_t > c0_t or c1_b > c0_b:
        fail(f"flat: an accepted cost rose (flat {c0_t} -> {c1_t}, block {c0_b} -> {c1_b})")
    _within("gn cost before", c0_b, c0_t, 1e-4)
    _within("gn cost after", c1_b, c1_t, 1e-3)
    step_err = max(_within("gn sdf", table(p_b.sdf), p_t.sdf, 5e-3, 5e-6),
                   _within("gn poses", p_b.poses, p_t.poses, 5e-3, 5e-6))

    # the block outer step at the same solver settings (device assembly + step)
    solver = dict(gn, cg_coeff_dtype="float32")
    mu = torch.tensor(1e-4, device=dev)
    level.outer_step(level.params, prob.depths, prob.images, mu, **solver)
    sync()
    t0 = time.perf_counter()
    level.outer_step(level.params, prob.depths, prob.images, mu, **solver)
    sync()
    block_outer_s = time.perf_counter() - t0
    log(f"  flat gn_iteration: cost {c0_t:.6f} -> {c1_t:.6f} tries {tries_t}; block (float32): {c0_b:.6f} -> "
        f"{c1_b:.6f} tries {tries_b}; params max |d| {step_err:.3e}")
    log(f"  flat outer step {asm_s + flat_gn_s:.4f}s (assembly {asm_s:.4f}s + step {flat_gn_s:.4f}s); block step on "
        f"the re-laid problem {block_gn_s:.4f}s; block outer step {block_outer_s:.4f}s (3 LM tries, 6 CG steps, "
        f"float32); launches {launches}")

    small = build_sphere_problem(
        voxel_size=0.02, image_size=(64, 48), num_frames=2, num_observations=2, perturb_sdf=0.002,
        perturb_albedo=0.05, device=dev,
    )
    cfg = dataclasses.replace(small.cfg, iterations=3)
    _, _, st = optimize_level(small.grid, small.topo, small.params, cfg, small.cam, small.depths, small.images,
                              small.voxel_sh, small.thres_shell, 0, use_blocks=False, device=dev)
    log(f"  flat optimize_level (small sphere, 3 iterations): costs {st.costs_before} -> {st.costs_after}, "
        f"tries {st.tries}, {st.elements} elements")
    if len(st.costs_after) != 3 or any(c1 > c0 for c0, c1 in zip(st.costs_before, st.costs_after)):
        fail(f"flat optimize_level: an accepted cost rose ({st.costs_before} -> {st.costs_after})")
    return dict(launches=launches, n_active=n_flat, asm_s=asm_s, flat_gn_s=flat_gn_s, block_gn_s=block_gn_s,
                block_outer_s=block_outer_s, checks=checks)


def bench_phase(n_flat_active: int) -> None:
    """The benchmark twins through their `main` (the module docstring's step
    14); each prints its JSON line."""
    import torch

    from intrinsic3d_torch import bench, bench_pipeline

    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    line = bench.main([])
    log(f"  bench twin: {time.perf_counter() - t0:.1f}s")
    d = line["detail"]
    if not (line["value"] > 0.0 and d["device"] == name):
        fail(f"bench twin: {line}")
    if d["active_eg_residuals"] != n_flat_active:
        fail(f"bench twin: {d['active_eg_residuals']} active E_g residuals, the flat phase counted {n_flat_active}")
    t0 = time.perf_counter()
    line = bench_pipeline.main(["--modes", "auto", "--repeats", "1"])
    log(f"  bench_pipeline twin: {time.perf_counter() - t0:.1f}s")
    d = line["detail"]
    if d["device"] != name or not all(run["phases_s"] for run in d["runs"]):
        fail(f"bench_pipeline twin: no phases recorded or wrong device ({d['device']})")
    if not d["refined_mesh_err_rms_m"] <= 0.5e-3:
        fail(f"bench_pipeline twin: refined mesh {d['refined_mesh_err_rms_m']} m rms from the sphere (bar 0.5 mm)")


def small_refinement_agrees() -> None:
    """The end-to-end test's scene (5 frames at 96x72, 2 grid and 2 pyramid
    levels) refined from one fused grid on the card and through the plain CPU
    path at converged solver settings (float32 coefficients, 100 CG steps,
    eta 1e-8): per-level costs rtol 1e-3 and equal tries, the same final
    voxel set, refined sdf within 1e-4 m, albedo within 1e-3 and colors
    within 0.5 (0..255) on it."""
    import numpy as np

    from intrinsic3d_torch.apps import app_fusion
    from intrinsic3d_torch.config import FusionConfig
    from intrinsic3d_torch.refine.intrinsic3d import Intrinsic3D
    from intrinsic3d_torch.synthetic import SMALL_REFINEMENT, SMALL_VOXEL, small_refinement_sensor

    fused = app_fusion.run(
        small_refinement_sensor(), FusionConfig(voxel_size=SMALL_VOXEL, discont_window_size=0), device="cpu"
    )
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        engine = Intrinsic3D(SMALL_REFINEMENT, small_refinement_sensor(), range(5), cg_iters=100, device=device,
                             cg_coeff_dtype="float32", cg_eta=1e-8)
        costs = []
        engine.add_callback(lambda i: costs.append((i.grid_level, i.pyramid_level, i.stats.costs_before,
                                                    i.stats.costs_after, i.stats.tries)))
        out[device] = (costs, engine.refine(fused), time.perf_counter() - t0)
    (tc, tg, ts), (cc, cg, cs) = out["cuda"], out["cpu"]
    for a, b in zip(tc, cc):
        log(f"  small refinement g{a[0]}p{a[1]}: cuda {a[2]} -> {a[3]} tries {a[4]}; cpu {b[2]} -> {b[3]} tries {b[4]}")
    if [c[:2] for c in tc] != [c[:2] for c in cc] or [c[4] for c in tc] != [c[4] for c in cc]:
        fail("small refinement: the card's schedule or LM tries differ from the CPU path's")
    for a, b in zip(tc, cc):
        if not np.allclose(a[2] + a[3], b[2] + b[3], rtol=1e-3, atol=0):
            fail(f"small refinement g{a[0]}p{a[1]}: costs on the card {a[2:4]} differ from the CPU path's {b[2:4]}")
    if tg.voxel_size != cg.voxel_size or not np.array_equal(tg.coords, cg.coords):
        fail(f"small refinement: voxel sets differ ({tg.num_voxels} on the card, {cg.num_voxels} on the CPU)")
    errs = (float(np.abs(tg.sdf_refined - cg.sdf_refined).max()), float(np.abs(tg.albedo - cg.albedo).max()),
            float(np.abs(tg.color - cg.color).max()))
    log(f"  small refinement: {tg.num_voxels} voxels at {tg.voxel_size} m on both; max |d sdf_refined| "
        f"{errs[0]:.3e}, max |d albedo| {errs[1]:.3e}, max |d color| {errs[2]:.3e}; card {ts:.2f}s, cpu {cs:.2f}s")
    if errs[0] > 1e-4 or errs[1] > 1e-3 or errs[2] > 0.5:
        fail("small refinement: the card's refined fields differ from the CPU path's")



def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (REPO / "intrinsic3d_torch" / "csrc").is_dir():
        print(f"chip_smoke: the intrinsic3d_torch package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    LOG.unlink(missing_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from intrinsic3d_torch import observations
    from intrinsic3d_torch.ops import build
    from intrinsic3d_torch.refine.solver import gn_iteration
    from intrinsic3d_torch.synthetic import BENCH_MU0, BENCH_PROBLEM, BENCH_SOLVER, build_sphere_problem

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.build_all()
    log(f"phase build: nvcc for {list(build.SOURCES)} in {time.perf_counter() - t0:.1f}s")
    for name, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if any(k in line for k in ("entry function", "registers", "spill")) or "error" in line.lower():
                log(f"  {name}: {line.strip()}")

    # --- bench-scale problem and warm-up outer iteration (records kernel inputs)
    dev = "cuda"
    t0 = time.perf_counter()
    prob = build_sphere_problem(**BENCH_PROBLEM, device=dev)
    level = prob.level()
    log(f"phase setup: num_voxels={prob.grid.num_voxels} num_blocks={level.layout.num_blocks} "
        f"frames={prob.images.shape[0]} in {time.perf_counter() - t0:.1f}s")

    captured = {}
    restore = [capture_linearization(captured), capture_first_call(observations, "nearest_rows", captured)]
    t0 = time.perf_counter()
    basm, bmasks = level.assemble(level.params, prob.depths, prob.images)
    n_active = int((basm.eg_w > 0).sum())
    mu = torch.tensor(BENCH_MU0, device=dev)
    _, c0, c1, _, tries = gn_iteration(level.params, basm, bmasks, mu, **BENCH_SOLVER, device=dev)
    torch.cuda.synchronize()
    for r in restore:
        r()
    if "linearization" in captured:
        captured.update(path_inputs(*captured.pop("linearization")))
    del basm, bmasks
    log(f"phase warmup: active_eg={n_active} cost {float(c0):.6f} -> {float(c1):.6f} tries={tries} "
        f"in {time.perf_counter() - t0:.2f}s")
    if set(captured) != {"bicubic_rows", "nearest_rows", "eg_rows"}:
        fail(f"the warm-up did not reach every kernel: {sorted(captured)}")

    # --- phase 1: kernels against their plain versions on the path's inputs
    records = check_kernels(captured)
    rows_inputs = captured["bicubic_rows"]
    del captured
    log("phase kernels: every kernel of the refinement path agrees with its plain version")

    # --- phase 2: chained outer iterations; counts zeroed just before. One
    # discarded outer step first lets the allocator settle after the
    # kernel timings (their CUDA graphs hold private memory pools).
    level.outer_step(level.params, prob.depths, prob.images, torch.tensor(BENCH_MU0, device=dev), **BENCH_SOLVER)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    p, mu, iter_s = level.params, torch.tensor(BENCH_MU0, device=dev), []
    for it in range(CHAINED_ITERS):
        t0 = time.perf_counter()
        p, c0, c1, mu, tries = level.outer_step(p, prob.depths, prob.images, mu, **BENCH_SOLVER)
        c0, c1 = float(c0), float(c1)
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t0)
        log(f"  outer {it}: cost {c0:.6f} -> {c1:.6f} tries={tries} mu={float(mu):.3e} {iter_s[-1]:.3f}s")
        if not (all(torch.isfinite(f).all() for f in p) and torch.isfinite(mu) and
                c0 == c0 and c1 == c1 and abs(c0) != float("inf") and abs(c1) != float("inf")):
            fail(f"non-finite values at outer iteration {it}")
        if c1 > c0:
            fail(f"outer iteration {it}: accepted cost {c1} above {c0}")
    launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase slice: {CHAINED_ITERS} outer iterations, median {statistics.median(iter_s):.4f}s "
        f"(min {min(iter_s):.4f}s, max {max(iter_s):.4f}s), launches {launches}, peak memory {peak_gb:.2f} GB")
    for r in records:
        r["launches"] = launches[r["name"]]
        r["status"] = "ok"
    for name in BLOCK_PATH_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was never launched on the refinement path")

    # --- phase 3: the result on a small problem against the plain CPU path
    small_problem_agrees()
    log("phase check: the card's trajectory matches the plain CPU path")

    # --- phase 3b: the flat-table oracle on the same problem; counts zeroed
    # just before its outer step and read just after
    flat = flat_phase(prob, level, n_active)
    by_name = {r["name"]: r for r in records}
    for rec in flat.pop("checks"):
        by_name[rec.pop("name")]["flat"] = {k: v for k, v in rec.items() if k not in ("route", "source", "replaces")}
    log("phase flat: the flat-table path ran through the kernels, which agree with their plain versions on its "
        "inputs, and matches the block path")
    del prob, level, p

    # --- phase 4: keyframes and fusion at bench_pipeline scale; counts zeroed
    # just before the measured run and read just after
    fusion = fusion_phase()
    for name, n in fusion["launches"].items():
        if name != "correct_sdf_dense" and n != 0:
            fail(f"kernel {name} launched {n} times on the fusion path, which has none of it")

    # --- phase 5: the refinement of the fused grid at bench_pipeline scale;
    # counts zeroed just before and read just after
    refinement = refinement_phase(fusion)
    for r in records:
        r["launches_pipeline_refinement"] = refinement["launches"][r["name"]]
        if r["name"] in refinement["sampler_levels"]:
            r.update(refinement["sampler_levels"][r["name"]])
    # the upsample kernel runs at the grid-level boundaries alone: its
    # launches are the pipeline refinement's
    for name, key in (("upsample_fields", "upsample"), ("level_static", "level_static")):
        rec = refinement.pop(key)
        rec.update(launches=refinement["launches"][name], status="ok",
                   launches_pipeline_refinement=refinement["launches"][name])
        records.append(rec)
    window_inputs, fusion_launches = fusion["window"], fusion["launches"]
    log("phase check: the pipeline refinement ran every level dense through the kernels and met its bars")

    # --- phase 5a: the same refinement with the level pipeline off and on,
    # four uncaptured runs in this call
    prefetch_phase(fusion, refinement)
    log("phase check: the refinement with the level pipeline off and on planned every level alike, started from "
        "the same first cost and met its bars")

    # --- phase 5b: the same refinement on two ranks sharing the card, the
    # dry run at 4 ranks, one rank over NCCL; each rank's counts zeroed just
    # before its refinement and read just after
    multi = multidevice_phase(fusion, refinement)
    del fusion, refinement["inputs"]
    for r in records:
        r["launches_multidevice"] = [lc[r["name"]] for lc in multi["launches"]]
    for rec in multi["kernels"]:
        by_name[rec.pop("name")]["multidevice"] = {
            k: v for k, v in rec.items() if k not in ("route", "source", "replaces")}
    log("phase check: the multi-device refinement ran through the kernels on every rank, matched the "
        "single-device first costs and first steps from the same starts and met its bars; the 4-rank dry run and "
        "the NCCL rank matched the single-device port")

    # --- phase 6: the three command-line apps at GoldenSceneSpec.full_scale();
    # counts zeroed just before the first app and read just after the last
    apps = apps_phase()
    for r in records:
        r["launches_apps"] = apps["launches"][r["name"]]
    log("phase check: the apps wrote every file, matched the in-process stages and met their bars")

    # --- phase 7: the 90-frame orbit (30 keyframes) refined through frame
    # buckets and streamed linearization; counts zeroed just before and read
    # just after. Then K1 and K2 against their plain versions on the sampler
    # inputs of the finest bucketed level's first call
    many = many_keyframe_phase()
    for r in records:
        r["launches_many_keyframe_refinement"] = many["launches"][r["name"]]
    log("phase check: the many-keyframe refinement ran bucketed and streamed levels through the kernels, "
        "met its bars, and its streamed runs tracked the one-shot and planned runs")
    for rec in check_kernels(many["captured"]):
        by_name[rec.pop("name")]["many_keyframe"] = {
            k: v for k, v in rec.items() if k not in ("route", "source", "replaces")}
    many_launches = many["launches"]
    del many
    log("phase kernels: every kernel of the bucketed path agrees with its plain version")

    # --- phase 8: the distance-transform kernel and the sampler's second entry
    # against their plain versions
    rec = check_distance_transform(window_inputs)
    rec.update(launches=fusion_launches["correct_sdf_dense"], status="ok",
               launches_pipeline_refinement=refinement["launches"]["correct_sdf_dense"],
               launches_apps=apps["launches"]["correct_sdf_dense"],
               launches_many_keyframe_refinement=many_launches["correct_sdf_dense"],
               launches_multidevice=[lc["correct_sdf_dense"] for lc in multi["launches"]])
    records.append(rec)
    del window_inputs
    for rec in check_sampler_sample(rows_inputs):
        rec.update(launches=0, status="ok", launches_pipeline_refinement=refinement["launches"][rec["name"]],
                   launches_apps=apps["launches"][rec["name"]],
                   launches_many_keyframe_refinement=many_launches[rec["name"]],
                   launches_multidevice=[lc[rec["name"]] for lc in multi["launches"]])
        records.append(rec)
    del rows_inputs
    log("phase kernels: the distance-transform kernel and bicubic_sample agree with their plain versions")

    # --- phase 9: small fusion and refinement problems on the card against the
    # CPU path
    small_fusion_agrees()
    log("phase check: the card's fusion matches the plain CPU path")
    small_refinement_agrees()
    log("phase check: the card's refinement matches the plain CPU path")

    # --- phase 10: the benchmark twins, each printing its JSON line
    bench_phase(flat["n_active"])
    log("phase bench: both benchmark twins ran and met their bars")

    for r in records:
        r["launches_flat"] = flat["launches"][r["name"]]
        if r["name"] in ("bicubic_rows_fwd", "bicubic_rows_fwdgrad", "nearest_rows") and r["launches_flat"] == 0:
            fail(f"kernel {r['name']} was never launched on the flat path")
    if len(records) != 9:
        fail(f"{len(records)} kernel records, expected 9")
    kernels = {"kernels": records}
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
