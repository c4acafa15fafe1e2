"""PDB -> LAMMPS data conversion (the reference's pdb2lmp).

Port of lammps_ani_tpu/tools/pdb.py: the fixed 7-type element mapping H,
C, N, O, S, F, Cl, the CRYST1 box, and bond detection by covalent radii
under the minimum image. Host-side numpy.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..io.lammps_data import LammpsData, write_lammps_data

SYMBOLS = ("H", "C", "N", "O", "S", "F", "Cl")
MASSES = (1.008, 12.0107, 14.0067, 15.999, 32.06, 18.998403163, 35.45)

# covalent radii (A) for bond detection, Cordero et al.
_COV_RADII = {"H": 0.31, "C": 0.76, "N": 0.71, "O": 0.66, "S": 1.05,
              "F": 0.57, "Cl": 1.02}


def _element_of(line: str) -> str:
    el = line[76:78].strip()
    if not el:
        name = line[12:16].strip()
        el = name[:2].capitalize() if name[:2].capitalize() in SYMBOLS \
            else name[0].upper()
    return el.capitalize() if len(el) > 1 else el.upper()


def read_pdb(path):
    """(species [n] int32, positions [n,3], box_h [3,3] or None)."""
    species, pos, box_h = [], [], None
    for line in Path(path).read_text().splitlines():
        if line.startswith("CRYST1"):
            a, b, c = (float(line[6:15]), float(line[15:24]),
                       float(line[24:33]))
            alpha, beta, gamma = (float(line[33:40]), float(line[40:47]),
                                  float(line[47:54]))
            box_h = _cell_to_h(a, b, c, alpha, beta, gamma)
        elif line.startswith(("ATOM", "HETATM")):
            el = _element_of(line)
            if el not in SYMBOLS:
                raise ValueError(f"unsupported element {el!r} (ANI set: "
                                 f"{SYMBOLS})")
            species.append(SYMBOLS.index(el))
            pos.append([float(line[30:38]), float(line[38:46]),
                        float(line[46:54])])
    return (np.asarray(species, np.int32), np.asarray(pos, float), box_h)


def _cell_to_h(a, b, c, alpha, beta, gamma):
    ca, cb, cg = (np.cos(np.radians(x)) for x in (alpha, beta, gamma))
    sg = np.sin(np.radians(gamma))
    lx = a
    xy = b * cg
    ly = b * sg
    xz = c * cb
    yz = c * (ca - cb * cg) / sg
    lz = np.sqrt(max(c * c - xz * xz - yz * yz, 0.0))
    return np.array([[lx, 0, 0], [xy, ly, 0], [xz, yz, lz]])


def detect_bonds(species, pos, box_h=None, tol: float = 1.2):
    """[(i, j)] pairs with r < tol * (r_cov_i + r_cov_j) (minimum image)."""
    n = len(pos)
    radii = np.array([_COV_RADII[SYMBOLS[s]] for s in species])
    bonds = []
    h = None if box_h is None else np.asarray(box_h, float)
    for i in range(n):
        d = pos[i + 1:] - pos[i]
        if h is not None:
            frac = d @ np.linalg.inv(h)
            d = (frac - np.round(frac)) @ h
        r = np.linalg.norm(d, axis=1)
        cut = tol * (radii[i] + radii[i + 1:])
        for j in np.nonzero(r < cut)[0]:
            bonds.append((i, i + 1 + int(j)))
    return bonds


def pdb_to_lammps_data(pdb_path, out_path, box_pad: float = 0.0,
                       with_bonds: bool = False):
    """Convert a PDB to a LAMMPS data file with the fixed 7-type mapping."""
    species, pos, box_h = read_pdb(pdb_path)
    if box_h is None:
        lo = pos.min(0) - box_pad
        hi = pos.max(0) + box_pad
        bounds = np.stack([lo, hi], axis=1)
        tilt = np.zeros(3)
    else:
        bounds = np.stack([np.zeros(3), np.diag(box_h)], axis=1)
        tilt = np.array([box_h[1, 0], box_h[2, 0], box_h[2, 1]])
    bonds = None
    if with_bonds:
        pairs = detect_bonds(species, pos, box_h)
        bonds = np.array([(1, i, j) for i, j in pairs], np.int64) \
            if pairs else np.zeros((0, 3), np.int64)
    data = LammpsData(
        species=species, positions=pos,
        masses_by_type=np.asarray(MASSES),
        box_bounds=bounds, tilt=tilt, bonds=bonds,
    )
    write_lammps_data(out_path, data)
    return data
