"""The default job kind: a whole reconstruction of the capture.

A job is what the three apps compute for one capture, in memory: keyframe
selection, fusion of every frame, the joint refinement, and with the
traffic's `exports` the app's per-level exports under the run's scratch
directory.

A traffic mix whose job needs code puts `traffic/<name>.py` beside its
`.json` and defines there any of the four hooks below, with the same
parameters; the others stay these. Every hook takes the cell's job kind
first, so the default `warm_up` and `window` run the mix's own `run_job`
and the check its own `readings`:

- `run_job(kind, cell, cap, dev, rec, traced, scratch, index) -> Job`: one
  job on the capture `cap` (`harness.prepare`), from its initial state;
- `warm_up(kind, cell, cap, dev, rec)`: set-up's work on the cell's shapes;
- `window(kind, cell, cap, dev, rec, traced, scratch, seconds) -> [Job]`:
  the measured window's jobs;
- `readings(kind, job, frames, cell, control=False, detail=None) -> dict`:
  the numbers compared for one job, each at or under the configuration's
  limit of the same name (`benchmark/check.py`).
"""

from __future__ import annotations

import dataclasses
import os
import time

from benchmark import harness


def run_job(kind, cell, cap, dev, rec, traced: bool, scratch: str, index: int):
    """Keyframes, fusion and `Intrinsic3D.refine`; with the traffic's
    `exports`, the app's `make_callback` at every level, writing under
    `scratch`; with its `"refine": false`, keyframes and fusion alone (a
    capture session). A traced job passes `stats=` to the engine and marks
    its stages for the profiler."""
    from intrinsic3d_torch.apps.app_intrinsic3d import make_callback
    from intrinsic3d_torch.refine.intrinsic3d import Intrinsic3D

    _, _, rf_cfg = cell.settings
    span = harness.spans(traced)
    solver = cell.config["solver"]
    job = harness.begin_job(cap, rec, traced)
    with span("job"):
        sel, fused = harness.keyframes_and_fusion(cell, cap.sensor, dev, job, traced)
        if not cell.traffic.get("refine", True):
            return harness.end_job(job, rec, dev)
        with span("refine"):
            engine = Intrinsic3D(rf_cfg, cap.sensor, sel.keyframe_ids(), cg_iters=int(solver["cg_iters"]), device=dev,
                                 cg_coeff_dtype=str(solver["cg_coeff_dtype"]), stats=job.stats)
            engine.add_callback(rec.on_level)
            if cell.traffic.get("exports"):
                job.export_dir = os.path.join(scratch, f"job{index}")
                out_cfg = dataclasses.replace(
                    rf_cfg, **{k: os.path.join(job.export_dir, v) for k, v in cell.traffic["exports"].items()})
                export = make_callback(out_cfg, cap.sensor, engine, job.exports)

                def on_level(info, export=export):
                    with span("exports"):
                        export(info)

                engine.add_callback(on_level)
            job.refined = engine.refine(fused, stats=job.stats)
            harness.sync(dev)
    return harness.end_job(job, rec, dev)


def warm_up(kind, cell, cap, dev, rec) -> None:
    """One job of the cell's kind on its own capture, cut to the coarsest
    grid level and two outer iterations, with no exports: every kernel, the
    native library and the solver's libraries load before the window."""
    _, _, rf_cfg = cell.settings
    warm = dataclasses.replace(
        cell, settings=(cell.settings[0], cell.settings[1],
                        dataclasses.replace(rf_cfg, num_grid_levels=1, iterations=min(2, rf_cfg.iterations))),
        traffic={k: v for k, v in cell.traffic.items() if k != "exports"})
    kind.run_job(warm, cap, dev, rec, False, "", -1)


def window(kind, cell, cap, dev, rec, traced: bool, scratch: str, seconds: float) -> list:
    """A closed loop with one job in flight: a new job starts while
    `seconds` have not passed, and none is cut short."""
    jobs = []
    t0 = time.perf_counter()
    while not jobs or time.perf_counter() - t0 < seconds:
        jobs.append(kind.run_job(cell, cap, dev, rec, traced, scratch, len(jobs)))
        harness.log(f"job {len(jobs)}: {jobs[-1].seconds:.3f}s")
    return jobs


def readings(kind, job, frames, cell, control: bool = False, detail=None) -> dict:
    """Every stage the job ran, held against the plain reference."""
    from benchmark import check

    return check.job_readings(job, frames, cell.config, cell.traffic.get("exports"), control=control, detail=detail)
