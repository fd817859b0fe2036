"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` into
`build/intrinsic3d_torch/lib<name>.so` at first use (rebuilt when the source
or a header of `csrc/` is newer), then loaded with `ctypes`. Nothing is compiled when a module is
imported. `build_all` starts one `nvcc` per source, all at once.

`LAUNCHES` is the one launch-count registry of the ops modules: one entry
per kernel entry, incremented by a wrapper where it launches its kernel and
nowhere else.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "intrinsic3d_torch"
SOURCES = ("bicubic_rows", "nearest_rows", "correct_sdf_dense")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel launches by entry; `reset_launches` zeroes them
LAUNCHES: Dict[str, int] = {
    "bicubic_rows_fwd": 0,
    "bicubic_rows_fwdgrad": 0,
    "nearest_rows": 0,
    "correct_sdf_dense": 0,
    "bicubic_sample_fwd": 0,
    "bicubic_sample_bwd": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# loaded libraries by source name (a process-wide cache of dlopen handles)
_LIBS: Dict[str, ctypes.CDLL] = {}
# compiler output of the builds this process ran, by source name
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (searched PATH and $CUDA_HOME/bin)")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a header of csrc/."""
    out = lib_path(name)
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return out.stat().st_mtime < newest


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile every stale source, one `nvcc` process each, all in parallel.
    Raises with the compiler's output if any build fails."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        BUILD_LOGS[n] = log
        if p.returncode != 0:
            failed.append(f"{n}.cu (exit {p.returncode}):\n{log}")
        else:
            os.replace(tmp, lib_path(n))  # atomic: a concurrent build never sees a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib
