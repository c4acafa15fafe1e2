"""Hydrogen mass repartitioning (the reference's apply_hmr).

Port of lammps_ani_tpu/tools/hmr.py. A pure array transform on the
per-atom masses, which `Simulation` takes as given: each hydrogen's mass
is scaled by `factor` and the added mass taken from its bonded heavy
atom, so the total mass is conserved exactly. The result is the data
file's per-atom `Hmrmass` section.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..io.lammps_data import LammpsData
from .pdb import detect_bonds


def repartition(species, masses, bonds, factor: float = 3.0,
                hydrogen_type: int = 0):
    """[n] new masses. `bonds`: iterable of (i, j) pairs (0-indexed)."""
    masses = np.asarray(masses, np.float64).copy()
    species = np.asarray(species)
    heavy_of = {}
    for i, j in bonds:
        if species[i] == hydrogen_type and species[j] != hydrogen_type:
            heavy_of[i] = j
        elif species[j] == hydrogen_type and species[i] != hydrogen_type:
            heavy_of[j] = i
    for h, heavy in heavy_of.items():
        delta = masses[h] * (factor - 1.0)
        masses[h] += delta
        masses[heavy] -= delta
    if np.any(masses <= 0):
        raise ValueError("HMR factor too large: a heavy atom went negative")
    return masses


def apply_hmr(data: LammpsData, factor: float = 3.0) -> LammpsData:
    """Return a copy of `data` with an Hmrmass per-atom section."""
    if data.bonds is not None and len(data.bonds):
        pairs = [(int(b[1]), int(b[2])) for b in data.bonds]
    else:
        pairs = detect_bonds(data.species, data.positions, data.box_h)
    new_masses = repartition(data.species, data.atom_masses, pairs, factor)
    return dataclasses.replace(data, per_atom_mass=new_masses)
