"""The yardstick the kernels are held to on the card: the H100's published
peaks, the least bytes a masked sampler must move, the bound they give, and
the L2-flushed timer whose time the bound is compared with.

`chip_smoke.py` and `python -m intrinsic3d_torch.ops.profile_sampler` both
read these, so their shares of the bound agree.
"""

from __future__ import annotations

import statistics

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and the float32
# rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# float operations per ACTIVE element, counted from csrc/bicubic_rows.cu:
# 2×(weight polynomials, ~10 ops each) + 16 tap FMAs + 4 row FMAs (an FMA is
# 2 ops) for the value; 4 weight polynomials + 2×16 + 3×4 FMAs with the
# derivatives; the backward drops the value's 4 row FMAs and adds 2 products
# by g
BICUBIC_OPS = {
    "fwd": 2 * 10 + 2 * (16 + 4),
    "fwdgrad": 4 * 10 + 2 * (2 * 16 + 3 * 4),
    "bwd": 4 * 10 + 2 * (2 * 16 + 2 * 4) + 2,
}


def bound(nbytes: float, nops: float):
    """(ms, "bytes" or "operations"): the larger of `nbytes` over the HBM
    rate and `nops` over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def needed_bytes(images, m: int, n_act: int, out_bytes: int, act_in_bytes: int = 12) -> int:
    """Bytes a masked per-element sampler must move: every element's 4 B
    `active` flag and its `out_bytes` of output, the `act_in_bytes` of index,
    coordinate (and cotangent) arrays of the active elements only (an
    inactive element needs nothing else), and the image stack once."""
    return m * (4 + out_bytes) + n_act * act_in_bytes + images.numel() * images.element_size()


def cold_ms(fn, reps: int = 20) -> float:
    """Median ms of one call of `fn` with the L2 cache flushed before it (a
    256 MB buffer, five times the H100's 50 MB L2, written between calls):
    the time against HBM of inputs that back-to-back calls would find in
    L2. The flush is queued ahead of each call, so the launch gap hides
    behind it."""
    import torch

    flush = torch.empty(2**26, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
