"""Build and bind the CUDA kernels of csrc/ (nvcc -> .so -> ctypes).

Each source in csrc/ is compiled at first use, from the package's own
files only, into `lammps_ani_torch/_build/` (listed in .gitignore), under
a name that carries a hash of the source and of the shared headers
(csrc/*.cuh), so an edited source rebuilds and an unchanged one is
loaded as built. Target: sm_90a (Hopper). The
library exposes a plain C interface; every entry point takes device
pointers and the stream as `void*` and returns a cudaError_t.

A failed build raises: there is no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("aev_roll.cu", "aev_asn.cu", "probes.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc_path() -> str:
    cands = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(source: str) -> Path:
    data = (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    for header in sorted(CSRC.glob("*.cuh")):
        data += header.read_bytes()
    digest = hashlib.sha256(data).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def start_build(source: str):
    """Start nvcc on one source; returns (target, Popen or None if the
    target is already built)."""
    out = _target(source)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc


def finish_build(out: Path, proc) -> str:
    """Wait for a build started by `start_build`; returns nvcc's output
    (ptxas register and shared-memory report). Raises on failure."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {out.name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict:
    """Build every source, all nvcc processes started together.
    Returns {source: {"seconds": s, "log": nvcc output}}."""
    t0 = time.perf_counter()
    started = {s: start_build(s) for s in SOURCES}
    report = {}
    for s, (out, proc) in started.items():
        log = finish_build(out, proc)
        report[s] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


@functools.lru_cache(maxsize=None)
def library(source: str = "aev_roll.cu") -> ctypes.CDLL:
    out, proc = start_build(source)
    finish_build(out, proc)
    return ctypes.CDLL(str(out))


@functools.lru_cache(maxsize=None)
def entry(name: str, nargs: int, source: str = "aev_roll.cu"):
    """A C entry point taking `nargs` pointer-sized arguments (c_void_p:
    a Python int passed bare would be cut to 32 bits); returns int."""
    fn = getattr(library(source), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * nargs
    return fn


def error_string(err: int, source: str = "aev_roll.cu") -> str:
    fn = getattr(library(source), f"{Path(source).stem}_error_string")
    fn.restype = ctypes.c_char_p
    fn.argtypes = [ctypes.c_int]
    return fn(err).decode()
