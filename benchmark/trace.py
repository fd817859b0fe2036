"""The traced run's profiler and the reductions of its events.

`Trace.open` starts `torch.profiler` on the CPU and the card; `Trace.close`
stops it and keeps two lists of (start, end, name) in seconds on the
profiler's clock: the device's operations (kernels, copies, sets) and the
host's ranges (torch operations and the harness's own `record_function`
marks: job, keyframes, fusion, refine, exports). The reductions below are
plain functions of such lists.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

Interval = Tuple[float, float, str]

# the harness's own ranges (`record_function`); the profiler also draws them
# on the device's timeline, where they are no operation
MARKS = ("job", "keyframes", "fusion", "refine", "exports")


class Trace:
    def __init__(self):
        self.device: List[Interval] = []
        self.host: List[Interval] = []
        self._prof = None
        self._cuda = True

    def open(self, cuda: bool = True):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._cuda = cuda
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        if cuda:
            torch.cuda.synchronize()

    def close(self):
        import torch

        if self._cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        for e in self._prof.profiler.kineto_results.events():
            start = e.start_ns() * 1e-9
            item = (start, start + e.duration_ns() * 1e-9, e.name())
            if "CUDA" not in str(e.device_type()):
                self.host.append(item)
            elif e.name() not in MARKS and not getattr(e, "is_user_annotation", lambda: False)():
                self.device.append(item)
        self._prof = None


def union(intervals: List[Interval], lo: float = float("-inf"), hi: float = float("inf")) -> List[Tuple[float, float]]:
    """The union of intervals clipped to [lo, hi], as sorted disjoint pairs."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e, _ in intervals if e > lo and s < hi)
    out: List[Tuple[float, float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        elif e > s:
            out.append((s, e))
    return out


def busy_seconds(intervals: List[Interval], lo: float, hi: float) -> float:
    """Seconds of [lo, hi] covered by at least one interval."""
    return sum(e - s for s, e in union(intervals, lo, hi))


def idle_gaps(intervals: List[Interval], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers, longest first."""
    gaps, t = [], lo
    for s, e in union(intervals, lo, hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def host_at(host: List[Interval], t: float, marks=MARKS) -> str:
    """What the host was doing at time t: the innermost harness mark and the
    shortest host range that covers t ("no torch op" when none does)."""
    covering = [(e - s, name) for s, e, name in host if s <= t <= e]
    mark = min((c for c in covering if c[1] in marks), default=(0.0, ""))[1]
    ops = [c for c in covering if c[1] not in marks]
    op = min(ops)[1] if ops else "no torch op"
    return f"{mark}: {op}" if mark else op


def top_ops(intervals: List[Interval], n: int = 10) -> List[list]:
    """The n device operation names that took the most time, with seconds."""
    tot = {}
    for s, e, name in intervals:
        tot[name] = tot.get(name, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def named_gaps(device: List[Interval], host: List[Interval], lo: float, hi: float, n: int = 10) -> List[list]:
    return [[host_at(host, 0.5 * (s + e)), e - s] for s, e in idle_gaps(device, lo, hi)[:n]]


def window_of(host: List[Interval], mark: str = "job") -> Optional[Tuple[float, float]]:
    """[first start, last end] of the harness's `mark` ranges."""
    spans = [(s, e) for s, e, name in host if name == mark]
    if not spans:
        return None
    return min(s for s, _ in spans), max(e for _, e in spans)
