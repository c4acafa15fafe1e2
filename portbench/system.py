"""The general generator of a traffic file's system.

A traffic file (`portbench/workloads/<traffic>.json`) names its system in
its "system" group, of one of two kinds, then replicated
`replicate` = [nx, ny, nz] times as LAMMPS' `replicate` does:

  "tile"       a tile of `file` (an .npz with `positions`, `box_h` (an
               orthorhombic box) and `box_origin`), its atoms' `symbols`;
  "placement"  `molecules` ({"symbols", "positions", "count"} each, in
               that order), one a cell of a shuffled lattice in a cube of
               `density_g_cm3` (masses from `masses_g_mol`), jittered by
               `jitter` cells, from `seed` (portbench/placement.py).

With `"centre": true` the replicated box is translated to span
[-L/2, L/2) on each axis (a box centred on the origin, as many LAMMPS data
files state it). Symbols are mapped to the configuration's species indices
and masses.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from . import placement

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class System:
    species: np.ndarray  # [n] int64, the configuration's species indices
    positions: np.ndarray  # [n, 3] float64, A
    lengths: np.ndarray  # [3] float64, the orthorhombic box's sides
    origin: np.ndarray  # [3] float64
    masses: np.ndarray  # [n] float64, g/mol

    @property
    def n_atoms(self) -> int:
        return len(self.species)


def _tile(spec):
    z = np.load(os.path.join(HERE, spec["file"]))
    h = np.asarray(z["box_h"], np.float64)
    if np.count_nonzero(h - np.diag(np.diag(h))):
        raise ValueError("a tile's box must be orthorhombic")
    return (list(spec["symbols"]), np.asarray(z["positions"], np.float64),
            np.diag(h).copy(), np.asarray(z["box_origin"], np.float64))


def _placement(spec):
    mols, mass = [], 0.0
    for m in spec["molecules"]:
        mpos = np.asarray(m["positions"], np.float64)
        mols += [(m["symbols"], mpos)] * int(m["count"])
        mass += int(m["count"]) * sum(spec["masses_g_mol"][s]
                                      for s in m["symbols"])
    edge = placement.cube_edge(mass, spec["density_g_cm3"])
    symbols, pos = placement.place(mols, edge, spec["jitter"], spec["seed"])
    return symbols, pos, np.full(3, edge), np.zeros(3)


KINDS = {"tile": _tile, "placement": _placement}


def build(traffic: dict, cfg: dict) -> System:
    spec = traffic["system"]
    symbols, pos, lengths, origin = KINDS[spec["kind"]](spec)
    nx, ny, nz = spec["replicate"]
    shifts = np.array([(i, j, k) for i in range(nx) for j in range(ny)
                       for k in range(nz)], np.float64) * lengths
    pos = (pos[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    lengths = lengths * np.array([nx, ny, nz], np.float64)
    if spec.get("centre"):
        pos = pos - (origin + lengths / 2)
        origin = -lengths / 2
    index = {s: i for i, s in enumerate(cfg["symbols"])}
    species = np.tile(np.array([index[s] for s in symbols], np.int64),
                      nx * ny * nz)
    masses = np.asarray(cfg["masses"], np.float64)[species]
    return System(species=species, positions=pos, lengths=lengths,
                  origin=origin, masses=masses)
