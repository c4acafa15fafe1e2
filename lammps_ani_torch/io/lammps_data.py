"""LAMMPS data: the `replicate` command.

Port of lammps_ani_tpu/io/lammps_data.py:207-234 (`replicate` and the
fields of `LammpsData` it needs); the reader and writer are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LammpsData:
    """Atoms and box. `species` is 0-indexed (type - 1)."""

    species: np.ndarray  # [n] int32
    positions: np.ndarray  # [n, 3] float64
    masses_by_type: np.ndarray  # [ntypes] float64
    box_bounds: np.ndarray  # [3, 2] (lo, hi)
    tilt: np.ndarray  # [3] (xy, xz, yz)
    velocities: np.ndarray | None = None  # [n, 3]

    @property
    def n_atoms(self) -> int:
        return len(self.species)

    @property
    def box_h(self) -> np.ndarray:
        (xlo, xhi), (ylo, yhi), (zlo, zhi) = self.box_bounds
        xy, xz, yz = self.tilt
        return np.array([[xhi - xlo, 0, 0], [xy, yhi - ylo, 0],
                         [xz, yz, zhi - zlo]], np.float64)

    @property
    def box_origin(self) -> np.ndarray:
        return self.box_bounds[:, 0].astype(np.float64)


def replicate(data: LammpsData, nx: int, ny: int, nz: int) -> LammpsData:
    """LAMMPS `replicate nx ny nz`."""
    h = data.box_h
    reps, vels = [], []
    for ix in range(nx):
        for iy in range(ny):
            for iz in range(nz):
                reps.append(data.positions + ix * h[0] + iy * h[1] + iz * h[2])
                if data.velocities is not None:
                    vels.append(data.velocities)
    bounds = data.box_bounds.copy()
    for d, f in enumerate((nx, ny, nz)):
        lo = bounds[d, 0]
        bounds[d, 1] = lo + (bounds[d, 1] - lo) * f
    return LammpsData(
        species=np.tile(data.species, nx * ny * nz),
        positions=np.concatenate(reps), masses_by_type=data.masses_by_type,
        box_bounds=bounds, tilt=data.tilt * np.array([ny, nz, nz]),
        velocities=np.concatenate(vels) if vels else None)
