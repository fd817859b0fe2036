"""Size sweep of the masked samplers K1a, K1b and K2 on the card.

    python -m intrinsic3d_torch.ops.profile_sampler [--min-log2 16] [--max-log2 27]
        [--active-share 1.0] [--reps 10]

For M = 2^min … 2^max elements on bench-like inputs (8 frames of 320x240,
elements frame-major in 512-element blocks whose coordinates fall in a
few-pixel window, as in the block-dense layout; all active, or a share of
them in whole active blocks), times the value sampler (`bicubic_rows`
without derivatives, K1a), the value-and-derivatives sampler (with them,
K1b) and the depth probe (`nearest_rows`, K2) one call at a time with the
50 MB L2 cache flushed before each (`roofline.cold_ms`), and prints each
time beside its bound (`roofline.bound` of `roofline.needed_bytes`) and its
share of it. Writes chiprun_out/profile_sampler_<share>.json. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path
from typing import Callable

import torch

from intrinsic3d_torch.ops import bicubic, build
from intrinsic3d_torch.ops.roofline import BICUBIC_OPS, bound, cold_ms, needed_bytes

KERNELS = ("bicubic_rows_fwd", "bicubic_rows_fwdgrad", "nearest_rows")
# bytes written per element and float operations per active element
# (`roofline.needed_bytes`, `roofline.BICUBIC_OPS`)
OUT_BYTES = {"bicubic_rows_fwd": 4, "bicubic_rows_fwdgrad": 12, "nearest_rows": 4}
OPS = {"bicubic_rows_fwd": BICUBIC_OPS["fwd"], "bicubic_rows_fwdgrad": BICUBIC_OPS["fwdgrad"], "nearest_rows": 0}


def entry_launcher(kernel: str) -> Callable:
    """The launch the wrappers make (counted in `LAUNCHES`): K1a's value,
    K1b's (value, ddx, ddy), K2's depths."""
    if kernel == "bicubic_rows_fwd":
        return lambda images, fid, x, y, active: bicubic._launch_bicubic(images, fid, x, y, active, False)[0]
    if kernel == "bicubic_rows_fwdgrad":
        return lambda images, fid, x, y, active: bicubic._launch_bicubic(images, fid, x, y, active, True)
    return bicubic._launch_nearest


def sweep_inputs(kernel: str, m: int, seed: int = 0, share: float = 1.0, k: int = 8, h: int = 240, w: int = 320):
    """Bench-like inputs on the card: `k` frames of `h` x `w`; elements
    frame-major in 512-element blocks, each block's coordinates within 4 px
    of a random centre; a share `share` of the elements active, in whole
    blocks (each active with probability min(1, 2 share)) and half of the
    elements of an active block (all, when `share` is 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    images = torch.rand((k, h, w), generator=gen, device=dev)
    nb = -(-m // 512)
    block_fid = (torch.arange(nb, device=dev) * k // nb).to(torch.int32)
    cx = 8.0 + torch.rand(nb, generator=gen, device=dev) * (w - 16.0)
    cy = 8.0 + torch.rand(nb, generator=gen, device=dev) * (h - 16.0)
    rep = lambda t: t.repeat_interleave(512)[:m]  # noqa: E731
    x = rep(cx) + (torch.rand(m, generator=gen, device=dev) - 0.5) * 8.0
    y = rep(cy) + (torch.rand(m, generator=gen, device=dev) - 0.5) * 8.0
    fid = rep(block_fid).contiguous()
    p_block = min(1.0, 2.0 * share)
    on = rep((torch.rand(nb, generator=gen, device=dev) < p_block).float())
    active = on * (torch.rand(m, generator=gen, device=dev) < share / p_block).float()
    if kernel != "nearest_rows":
        return images, fid, x.contiguous(), y.contiguous(), active
    yi = torch.clamp(torch.floor(y + 0.5), 0, h - 1).to(torch.int32)
    xi = torch.clamp(torch.floor(x + 0.5), 0, w - 1).to(torch.int32)
    return images, fid, yi, xi, active


def sweep(min_log2: int, max_log2: int, reps: int, share: float = 1.0) -> list:
    rows = []
    for kernel in KERNELS:
        fn = entry_launcher(kernel)
        for lg in range(min_log2, max_log2 + 1):
            m = 2**lg
            inputs = sweep_inputs(kernel, m, seed=lg, share=share)
            n_act = int((inputs[4] > 0).sum())
            b_ms, b_by = bound(needed_bytes(inputs[0], m, n_act, OUT_BYTES[kernel]), n_act * OPS[kernel])
            row = dict(kernel=kernel, m=m, active=n_act, bound_ms=b_ms, bound_by=b_by,
                       cold_ms=cold_ms(lambda: fn(*inputs), reps))
            row["pct_of_bound"] = 100 * b_ms / row["cold_ms"]
            print(f"  {kernel} M=2^{lg}={m} active {n_act}: bound {b_ms:.4f} ms ({b_by}); L2-flushed "
                  f"{row['cold_ms']:.4f} ms ({row['pct_of_bound']:.0f}%)", flush=True)
            rows.append(row)
            del inputs
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--min-log2", type=int, default=16)
    ap.add_argument("--max-log2", type=int, default=27)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--active-share", type=float, default=1.0, help="share of active elements (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sampler: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build_all(("bicubic_rows", "nearest_rows"))
    rows = sweep(args.min_log2, args.max_log2, args.reps, args.active_share)
    out = Path(build.BUILD_DIR).parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_sampler_{args.active_share:g}.json").write_text(
        json.dumps(dict(card=smi, active_share=args.active_share, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
