"""Host preparation on a background thread, overlapped with the card's work.

The refinement's level loop builds, between device stages, host structures
that depend only on what is already fixed when the previous stage starts:
a level's block layout, element plan, stencil tables and statics
(`refine.optimizer.LevelPrep`, overlapped with the SVSH lighting estimate),
and the next grid level's upsample and sparsify index tables
(`grid.algorithms.UpsamplePrep`, overlapped with the solve). `HostPrep` is
their common thread.

Rules every prep keeps, so that the overlap changes no result:
- the thread touches no CUDA state and no collective and creates no tensor:
  the current stream is per device, so a copy or a synchronizing call from
  the thread would queue behind the main thread's kernels, and a collective
  would interleave with the main thread's in a different order on each rank.
  Its inputs are host copies made by the calling thread before it starts,
  its products numpy arrays and host objects; every upload happens on the
  main thread after `join`;
- `join` re-raises the thread's exception on the calling thread: a failing
  prep fails the level rather than hide behind a slower serial rebuild;
  it waits under a `join[<thread name>]` span (`timer.span`), so a
  profiler's timeline names the main thread's wait for a prep. A prep
  thread that waits for another calls `wait` and `result`, which open no
  span;
- the products are bitwise what the serial path builds, because both run
  the same host functions on the same inputs.
"""

from __future__ import annotations

import threading
import time

from intrinsic3d_torch.timer import span


class HostPrep:
    """Runs `self._prepare()` on a daemon thread from construction on.

    `seconds` is the thread's own wall clock (set when it ends), `join()`
    waits for it under a `join[<thread name>]` span and re-raises its
    exception, `wait()` only waits (for clean-up paths that must not mask
    another exception, and for a prep thread waiting for another), and
    `result()` re-raises the exception of an ended thread."""

    THREAD_PREFIX = "i3d-prep"

    def __init__(self, name: str):
        self.seconds = 0.0
        self._exc = None
        self._thread = threading.Thread(target=self._run, name=f"{self.THREAD_PREFIX}:{name}", daemon=True)
        self._thread.start()

    def _prepare(self) -> None:
        raise NotImplementedError

    def _run(self) -> None:
        t0 = time.perf_counter()
        try:
            self._prepare()
        except BaseException as exc:  # noqa: BLE001 — handed to the joining thread
            self._exc = exc
        finally:
            self.seconds = time.perf_counter() - t0

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def wait(self) -> "HostPrep":
        self._thread.join()
        return self

    def result(self) -> "HostPrep":
        if self._exc is not None:
            raise self._exc
        return self

    def join(self) -> "HostPrep":
        with span(f"join[{self._thread.name}]"):
            self._thread.join()
        return self.result()
