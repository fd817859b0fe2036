"""Readings behind the limits of `correct`: for each seed, one job of the
cell at its own size, on the run's own set-up and job path
(`harness.load_program`, `harness.prepare`, the cell's job kind), then every
number compared twice, once with the program's outputs (the sound reading)
and once with the reference computed in bfloat16 in the program's place
(the control, which has to come out not correct). Not part of a benchmark
run.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 [--out chiprun_out/control.jsonl]

Prints one JSON line a seed and a summary line: each number's largest sound
reading, smallest control reading and the cell's limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time


def readings(workload: str, seeds, device: str = "cuda", root=None):
    """Yield {seed, job_s, sound, detail, control} for each seed (one job
    each)."""
    import torch

    from benchmark import check, harness

    root = harness.ROOT if root is None else root
    cell = harness.load_cell(workload, root)
    dev = torch.device(device)
    harness.load_program(dev)
    rec = harness.Recorder()
    rec.install()
    try:
        for seed in seeds:
            t0 = time.perf_counter()
            cap = harness.prepare(cell, seed, dev)
            scratch = tempfile.mkdtemp(prefix="i3d_control_")
            try:
                job = cell.kind.run_job(cell, cap, dev, rec, False, scratch, 0)
                job_s = time.perf_counter() - t0
                fr = check.Frames(cap.frames, cell.config, dev)
                detail = {}
                out = dict(seed=seed, job_s=job_s, sound=cell.kind.readings(job, fr, cell, detail=detail))
                out["detail"] = detail
                out["control"] = cell.kind.readings(job, fr, cell, control=True)
            finally:
                shutil.rmtree(scratch, ignore_errors=True)
            yield out
    finally:
        rec.uninstall()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from benchmark import harness

    limits = harness.load_cell(args.workload).config["limits"]
    sound, ctrl = {}, {}
    sink = open(args.out, "a") if args.out else None
    try:
        for r in readings(args.workload, [int(s) for s in args.seeds.split(",")]):
            line = json.dumps(dict(workload=args.workload, **r))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            for k, v in r["sound"].items():
                sound[k] = max(sound.get(k, float("-inf")), v)
            for k, v in r["control"].items():
                ctrl[k] = min(ctrl.get(k, float("inf")), v)
    finally:
        if sink:
            sink.close()
    summary = {k: dict(lower=sound[k], control=ctrl.get(k), limit=limits.get(k)) for k in sound}
    print(json.dumps(dict(workload=args.workload, summary=summary)), flush=True)
    print(json.dumps(summary, indent=1), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
