"""The refinement's phase seconds, its spans on the profiler's timeline, and
the level solve's count of device-to-host reads.

`span(name)` opens a `torch.profiler.record_function` range on the calling
thread while a profiler runs (a benchmark's traced run, `tools/profile_*`),
so that the profiler draws the program's phases and their children on the
same clock as the device's work. With no profiler running it opens none
(an idle `record_function` still costs 11–13 µs of host time on an H100
machine, and a refinement opens about two hundred spans).
`span(name, phase=True)` is a phase: at its
end its host-clock seconds go to `record_phase`, the one writer of phase
seconds, which appends them to the process's phase list (`phases_snapshot`,
as the JAX package's `timer` does) and writes them into the dict of every
running `collect` block (the engine's `stats=`). A span never synchronizes
the device: the device's side of a phase is read from the trace, inside the
span. Spans open on the main thread only; the host preparation threads call
nothing of torch (`prefetch.py`).

`HOST_READS` counts the level solve's device-to-host reads by site, as
`ops.build.LAUNCHES` counts kernel launches: an increment where a value is
read to the host and nowhere else. Each such read waits for every kernel
queued before it.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional

# --- global pipeline phase recorder ----------------------------------------
#
# The refinement driver records every timed phase here, its name tagged with
# the grid/pyramid level, so the same phase of repeated runs has the same
# name; bench_pipeline publishes the phases and, per run, the excess of each
# phase over its best time across runs.

_PIPELINE_PHASES: list = []
# the `stats` dicts of the running `collect` blocks
_SINKS: list = []


def record_phase(name: str, seconds: float) -> None:
    seconds = float(seconds)
    _PIPELINE_PHASES.append((name, seconds))
    for stats in _SINKS:
        stats[name] = seconds


def phases_snapshot() -> list:
    return list(_PIPELINE_PHASES)


def phases_reset() -> None:
    _PIPELINE_PHASES.clear()


@contextmanager
def collect(stats: Optional[dict]):
    """Inside the block, every recorded phase is also written into `stats`
    (when it is a dict) under its name."""
    if stats is None:
        yield
        return
    _SINKS.append(stats)
    try:
        yield
    finally:
        _SINKS.remove(stats)


class span:
    """`with span(name[, phase=True]) as s:` — a `record_function` range
    named `name` around the block while a profiler runs; `s.seconds` is the
    block's host-clock seconds once it ends, and with `phase` they are
    recorded (`record_phase`) when the block ends without an exception."""

    __slots__ = ("name", "phase", "seconds", "_range", "_t0")

    def __init__(self, name: str, phase: bool = False):
        self.name = name
        self.phase = phase
        self.seconds = 0.0

    def __enter__(self) -> "span":
        from torch.autograd import profiler

        self._range = None
        if profiler._is_profiler_enabled:
            from torch.profiler import record_function

            self._range = record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if self.phase and exc_type is None:
            record_phase(self.name, self.seconds)


# device-to-host reads of the level solve, by site: the PCG's residual test,
# the LM acceptance test, the outer iteration's record (cost before, cost
# after, damping) and the device assembly's occlusion test
HOST_READS: Dict[str, int] = {
    "pcg_residual": 0,
    "lm_acceptance": 0,
    "iteration_record": 0,
    "occlusion_test": 0,
}


def host_reads() -> int:
    """Every site's reads so far (a level stores its difference)."""
    return sum(HOST_READS.values())
