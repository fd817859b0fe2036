"""Wall-clock phase timer (the reference's ``nv::Timer``,
``libintrinsic3d/include/nv/timer.h:45-80``) plus a phase-accumulating
variant used for pipeline telemetry — the moral equivalent of the
NLSSolver's time_add/time_build/time_solve counters
(``src/refinement/nls_solver.cpp:192-203``).

Copy of `intrinsic3d_tpu/timer.py` (standard library only).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class Timer:
    def __init__(self):
        self._start = 0.0
        self._elapsed = 0.0
        self.start()

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> None:
        self._elapsed = time.perf_counter() - self._start

    def elapsed(self) -> float:
        """Seconds between the last start() and stop()."""
        return self._elapsed


# --- global pipeline phase recorder ----------------------------------------
#
# The refinement driver records every timed phase here, its name tagged with
# the grid/pyramid level, so the same phase of repeated runs has the same
# name; bench_pipeline publishes the phases and, per run, the excess of each
# phase over its best time across runs.

_PIPELINE_PHASES: list = []


def record_phase(name: str, seconds: float) -> None:
    _PIPELINE_PHASES.append((name, float(seconds)))


def phases_snapshot() -> list:
    return list(_PIPELINE_PHASES)


def phases_reset() -> None:
    _PIPELINE_PHASES.clear()


class PhaseTimer:
    """Accumulate named phase durations: `with phases.phase("solve"): ...`"""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        return "; ".join(
            f"{k}: {v:.2f}s (x{self.counts[k]})" for k, v in sorted(self.totals.items())
        )
