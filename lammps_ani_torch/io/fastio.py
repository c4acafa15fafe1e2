"""ctypes bindings for the native data-file parser (csrc/fastio.cpp).

Port of lammps_ani_tpu/io/fastio.py. The repository's csrc/fastio.cpp is
built with g++ at first use into `lammps_ani_torch/_build/` (listed in
.gitignore), under a name that carries a hash of the source, so an edited
source rebuilds. `read_lammps_data(..., fast=True)` (io/lammps_data.py)
parses through it and takes the Python parser where it cannot be built
(no compiler): both give the same arrays. A host parser; no device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "csrc" / "fastio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")


def _target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfastio_{digest}.so"


def _build() -> Path:
    """Compile the parser unless built; returns the library's path.
    Raises CalledProcessError or OSError when it cannot be built."""
    out = _target()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def get_lib():
    """The native parser, built at first use; None if it cannot be
    built or loaded."""
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.lmp_parse.restype = ctypes.c_void_p
    lib.lmp_parse.argtypes = [ctypes.c_char_p]
    lib.lmp_error.restype = ctypes.c_char_p
    lib.lmp_error.argtypes = [ctypes.c_void_p]
    for fn in ("lmp_n_atoms", "lmp_n_bonds"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn in ("lmp_n_types", "lmp_has_vel", "lmp_has_hmr"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.lmp_copy.restype = None
    lib.lmp_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 8
    lib.lmp_free.restype = None
    lib.lmp_free.argtypes = [ctypes.c_void_p]
    return lib


def read_lammps_data_native(path):
    """Parse with the C++ parser; a LammpsData, or None where the parser
    is unavailable. A malformed file raises ValueError."""
    from .lammps_data import LammpsData

    lib = get_lib()
    if lib is None:
        return None
    h = lib.lmp_parse(str(path).encode())
    try:
        err = lib.lmp_error(h)
        if err:
            raise ValueError(f"fastio: {err.decode()} ({path})")
        n = lib.lmp_n_atoms(h)
        nb = lib.lmp_n_bonds(h)
        nt = lib.lmp_n_types(h)
        species = np.empty(n, np.int32)
        pos = np.empty((n, 3), np.float64)
        vel = np.empty((n, 3), np.float64) if lib.lmp_has_vel(h) else None
        hmr = np.empty(n, np.float64) if lib.lmp_has_hmr(h) else None
        masses = np.empty(max(nt, 1), np.float64)
        bounds = np.empty(6, np.float64)
        tilt = np.empty(3, np.float64)
        bonds = np.empty((nb, 3), np.int64) if nb else None

        def ptr(a):
            return None if a is None else a.ctypes.data_as(ctypes.c_void_p)

        lib.lmp_copy(h, ptr(species), ptr(pos), ptr(vel), ptr(hmr),
                     ptr(masses), ptr(bounds), ptr(tilt), ptr(bonds))
        return LammpsData(
            species=species, positions=pos, masses_by_type=masses,
            box_bounds=bounds.reshape(3, 2), tilt=tilt, velocities=vel,
            per_atom_mass=hmr, bonds=bonds)
    finally:
        lib.lmp_free(h)
