"""The rank's view of the device mesh, and the collectives it calls.

Counterpart of `intrinsic3d_tpu/parallel/sharding.py::make_mesh`: a JAX
`Mesh` over a `data` axis becomes one process per rank of a
`torch.distributed` process group. `init_mesh` joins the group with an
explicit backend — `"nccl"` with one card per rank, `"gloo"` where ranks
share a card or run on the CPU (gloo reduces, gathers and exchanges CUDA
tensors through host memory) — and returns the frozen `Mesh` every
multi-device function takes.

Every collective of the port goes through a `Mesh` method, which counts the
calls and the host seconds spent inside them (`Mesh.stats`). A collective
blocks until every rank of the group has called it, so every rank must call
the same collectives in the same order: each host-side branch of the
multi-device code reads values that were all-reduced first, which are equal
on every rank.

Not ported: `shard_problem`, `shard_assembly`, `shard_block_problem` and
`replicate`, the placements that let XLA's partitioner insert the
collectives; the port has no partitioner, and the explicit path computes the
same step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

import torch
import torch.distributed as dist

from intrinsic3d_torch.device import resolve_device

BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass
class CollectiveStats:
    """Calls and host seconds inside collectives, per kind."""

    calls: dict = dataclasses.field(default_factory=dict)
    seconds: dict = dataclasses.field(default_factory=dict)

    def add(self, kind: str, seconds: float) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.seconds[kind] = self.seconds.get(kind, 0.0) + seconds

    def reset(self) -> None:
        self.calls.clear()
        self.seconds.clear()

    def total(self):
        """(calls, seconds) over all kinds."""
        return sum(self.calls.values()), sum(self.seconds.values())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's handle on a one-axis mesh of `size` ranks."""

    group: object  # torch.distributed ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: str
    ranks_on_device: int = 1  # ranks of the mesh sharing this rank's device
    stats: CollectiveStats = dataclasses.field(default_factory=CollectiveStats, compare=False)

    def _timed(self, kind: str, fn):
        t0 = time.perf_counter()
        out = fn()
        self.stats.add(kind, time.perf_counter() - t0)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks (a `psum`); returns a new tensor."""
        out = t.contiguous().clone()
        self._timed("all_reduce", lambda: dist.all_reduce(out, group=self.group))
        return out

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `t` (equal shapes), in rank order."""
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        self._timed("all_gather", lambda: dist.all_gather(out, t, group=self.group))
        return out

    def all_gather_cat(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's `t` concatenated along `dim` in rank order."""
        return torch.cat(self.all_gather(t.movedim(dim, 0)), dim=0).movedim(0, dim)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `t` on every rank; returns a new tensor."""
        out = t.contiguous().clone()
        self._timed("broadcast", lambda: dist.broadcast(out, src, group=self.group))
        return out

    def all_to_all(self, inp: torch.Tensor, in_splits: Sequence[int], out_splits: Sequence[int]) -> torch.Tensor:
        """Ship rows `inp[sum(in_splits[:r]) : …]` to rank r and receive
        `out_splits[s]` rows from each rank s, in rank order (dim 0)."""
        out = inp.new_empty((int(sum(out_splits)),) + tuple(inp.shape[1:]))
        self._timed(
            "all_to_all",
            lambda: dist.all_to_all_single(
                out, inp.contiguous(), list(out_splits), list(in_splits), group=self.group
            ),
        )
        return out


def init_mesh(world_size: int, rank: int, *, backend: str, init_method: str, device) -> Mesh:
    """Join the process group and return this rank's `Mesh`.

    `backend` is `"gloo"` or `"nccl"`; nothing picks one for the caller.
    `device` is the rank's device: `"cpu"`, a device with an index, or
    `"cuda"`, which means card `rank % torch.cuda.device_count()` (one card
    per rank where there are enough, ranks sharing card 0 where there is
    one). NCCL needs a card of its own per rank. `init_method` is the
    group's rendezvous (`file://…`, `tcp://localhost:<port>` or `env://`)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs CUDA devices")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    devices = [None] * world_size
    dist.all_gather_object(devices, str(dev))
    return Mesh(group=dist.group.WORLD, rank=rank, size=world_size, device=dev, backend=backend,
                ranks_on_device=devices.count(str(dev)))


def close_mesh(mesh: Mesh) -> None:
    """Leave the process group."""
    dist.destroy_process_group(mesh.group)
