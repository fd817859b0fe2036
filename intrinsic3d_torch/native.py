"""ctypes binding of the native host library (`native/i3d_host.cpp`).

Counterpart of `intrinsic3d_tpu/native.py`: the hash-lookup and
neighbor-table primitives for the topology rebuilds between refinement
levels (the reference's equivalent work lived in its C++ voxel hash map,
``libintrinsic3d/src/sparse_voxel_grid.cpp``). The unchanged source is
compiled with `g++ -O3 -march=native -fopenmp` into
`build/intrinsic3d_torch/libi3d_host.so` at first use (rebuilt when the
source is newer) and never into `native/`. A failed build raises with the
compiler's output; there is no numpy fallback here — the numpy route
(`grid.voxel_grid.find_indices`) is the plain version the tests compare
with.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "i3d_host.cpp"
LIB = Path(__file__).resolve().parents[1] / "build" / "intrinsic3d_torch" / "libi3d_host.so"
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    """Compile into a name of this process's own, then rename over the
    library: workers building at once never load a partial file."""
    LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_name(f"{LIB.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"building {SRC.name} failed (exit {e.returncode}):\n{e.stderr}") from e
    except OSError as e:
        raise RuntimeError(f"building {SRC.name}: cannot run g++ ({e})") from e
    os.replace(tmp, LIB)


def get_lib() -> ctypes.CDLL:
    """The loaded library, building it first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if not LIB.exists() or LIB.stat().st_mtime < SRC.stat().st_mtime:
                _build()
            lib = ctypes.CDLL(str(LIB))
            i64 = ctypes.c_int64
            p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.i3d_neighbor_table.argtypes = [p32, i64, p32, i64, p32]
            lib.i3d_find_indices.argtypes = [p32, i64, p32, i64, p32]
            lib.i3d_neighbor_table.restype = lib.i3d_find_indices.restype = None
            _lib = lib
        return _lib


def neighbor_table(coords: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Gather-index table `[n, s]` (−1 absent) in the given coord order."""
    coords = np.ascontiguousarray(coords, np.int32).reshape(-1, 3)
    offsets = np.ascontiguousarray(offsets, np.int32).reshape(-1, 3)
    out = np.empty((len(coords), len(offsets)), np.int32)
    get_lib().i3d_neighbor_table(coords, len(coords), offsets, len(offsets), out)
    return out


def find_indices(coords: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Table indices `[m]` of query coords `[m, 3]` (−1 absent)."""
    coords = np.ascontiguousarray(coords, np.int32).reshape(-1, 3)
    q = np.ascontiguousarray(queries, np.int32).reshape(-1, 3)
    out = np.empty(len(q), np.int32)
    get_lib().i3d_find_indices(coords, len(coords), q, len(q), out)
    return out
