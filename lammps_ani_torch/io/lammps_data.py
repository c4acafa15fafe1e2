"""LAMMPS data files: reader, writer and the `replicate` command.

Port of lammps_ani_tpu/io/lammps_data.py. The subset the reference
workloads use: a header with counts and (possibly triclinic) box bounds,
`Masses`, `Atoms` (atom_style atomic: id type x y z [image flags]),
`Velocities`, `Bonds`, and the per-atom `Hmrmass` section of hydrogen mass
repartitioning (tools/hmr.py). Host-side numpy; no device.

The fixed 7-type species mapping H, C, N, O, S, F, Cl is the reference's
(pdb2lmp).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

SPECIES_SYMBOLS = ("H", "C", "N", "O", "S", "F", "Cl")
SPECIES_MASSES = (1.008, 12.0107, 14.0067, 15.999, 32.06, 18.998403163, 35.45)
SYMBOL_TO_TYPE = {s: i + 1 for i, s in enumerate(SPECIES_SYMBOLS)}


@dataclasses.dataclass
class LammpsData:
    """Atoms and box. `species` is 0-indexed (type - 1)."""

    species: np.ndarray  # [n] int32
    positions: np.ndarray  # [n, 3] float64
    masses_by_type: np.ndarray  # [ntypes] float64
    box_bounds: np.ndarray  # [3, 2] (lo, hi)
    tilt: np.ndarray  # [3] (xy, xz, yz)
    velocities: np.ndarray | None = None  # [n, 3]
    per_atom_mass: np.ndarray | None = None  # [n] (HMR override)
    bonds: np.ndarray | None = None  # [nbonds, 3] (type, i, j) 0-indexed

    @property
    def n_atoms(self) -> int:
        return len(self.species)

    @property
    def atom_masses(self) -> np.ndarray:
        if self.per_atom_mass is not None:
            return self.per_atom_mass
        return self.masses_by_type[self.species]

    @property
    def box_h(self) -> np.ndarray:
        (xlo, xhi), (ylo, yhi), (zlo, zhi) = self.box_bounds
        xy, xz, yz = self.tilt
        return np.array([[xhi - xlo, 0, 0], [xy, yhi - ylo, 0],
                         [xz, yz, zhi - zlo]], np.float64)

    @property
    def box_origin(self) -> np.ndarray:
        return self.box_bounds[:, 0].astype(np.float64)


_SECTION_NAMES = {
    "Masses", "Atoms", "Velocities", "Bonds", "Angles", "Dihedrals",
    "Impropers", "Hmrmass", "Pair Coeffs", "Bond Coeffs", "Angle Coeffs",
}


def _strip_comment(line: str) -> str:
    return line.split("#", 1)[0].strip()


def read_lammps_data(path, fast: bool | None = None) -> LammpsData:
    """Parse a data file. `fast=None` takes the native parser
    (io/fastio.py) for files above 1 MB and the Python parser otherwise,
    or where the native one cannot be built; `fast=False` forces the
    Python parser (the behavior oracle)."""
    if fast is None:
        fast = Path(path).stat().st_size > 1 << 20
    if fast:
        from . import fastio

        parsed = fastio.read_lammps_data_native(path)
        if parsed is not None:
            return parsed
    lines = Path(path).read_text().splitlines()
    n_atoms = n_types = n_bonds = 0
    bounds = np.zeros((3, 2))
    tilt = np.zeros(3)

    # header: everything until the first recognized section keyword (the
    # first line is a title)
    i = 1
    while i < len(lines):
        if any(_strip_comment(lines[i]).startswith(s)
               for s in _SECTION_NAMES):
            break
        bare = _strip_comment(lines[i])
        if bare:
            toks = bare.split()
            if bare.endswith("atoms"):
                n_atoms = int(toks[0])
            elif bare.endswith("atom types"):
                n_types = int(toks[0])
            elif bare.endswith("bonds"):
                n_bonds = int(toks[0])
            elif bare.endswith("xlo xhi"):
                bounds[0] = [float(toks[0]), float(toks[1])]
            elif bare.endswith("ylo yhi"):
                bounds[1] = [float(toks[0]), float(toks[1])]
            elif bare.endswith("zlo zhi"):
                bounds[2] = [float(toks[0]), float(toks[1])]
            elif bare.endswith("xy xz yz"):
                tilt[:] = [float(toks[0]), float(toks[1]), float(toks[2])]
        i += 1

    masses = np.zeros(max(n_types, 1))
    species = np.zeros(n_atoms, np.int32)
    pos = np.zeros((n_atoms, 3))
    vel = hmr = bonds = None

    def read_section(start: int, n_rows: int):
        rows = []
        j = start
        while j < len(lines) and len(rows) < n_rows:
            bare = _strip_comment(lines[j])
            if bare:
                rows.append(bare.split())
            j += 1
        return rows, j

    while i < len(lines):
        head = _strip_comment(lines[i])
        if not head:
            i += 1
            continue
        if head.startswith("Masses"):
            rows, i = read_section(i + 1, n_types)
            for r in rows:
                masses[int(r[0]) - 1] = float(r[1])
        elif head.startswith("Atoms"):
            rows, i = read_section(i + 1, n_atoms)
            for r in rows:
                aid = int(r[0]) - 1
                species[aid] = int(r[1]) - 1
                pos[aid] = [float(r[2]), float(r[3]), float(r[4])]
        elif head.startswith("Velocities"):
            vel = np.zeros((n_atoms, 3))
            rows, i = read_section(i + 1, n_atoms)
            for r in rows:
                vel[int(r[0]) - 1] = [float(r[1]), float(r[2]), float(r[3])]
        elif head.startswith("Hmrmass"):
            hmr = np.zeros(n_atoms)
            rows, i = read_section(i + 1, n_atoms)
            for r in rows:
                hmr[int(r[0]) - 1] = float(r[1])
        elif head.startswith("Bonds"):
            bonds = np.zeros((n_bonds, 3), np.int64)
            rows, i = read_section(i + 1, n_bonds)
            for k, r in enumerate(rows):
                bonds[k] = [int(r[1]), int(r[2]) - 1, int(r[3]) - 1]
        else:
            i += 1

    return LammpsData(species=species, positions=pos, masses_by_type=masses,
                      box_bounds=bounds, tilt=tilt, velocities=vel,
                      per_atom_mass=hmr, bonds=bonds)


def write_lammps_data(path, data: LammpsData,
                      comment="generated by lammps_ani_torch"):
    """Write `data`: the header (a tilt line where the box is triclinic),
    Masses, Atoms, and Velocities, Bonds and Hmrmass where present."""
    n = data.n_atoms
    ntypes = len(data.masses_by_type)
    has_bonds = data.bonds is not None and len(data.bonds) > 0
    out = [f"# {comment}", f"{n} atoms", f"{ntypes} atom types"]
    if has_bonds:
        n_bond_types = int(np.max(data.bonds[:, 0]))
        out += [f"{len(data.bonds)} bonds", f"{n_bond_types} bond types"]
    for dim, (lo, hi) in zip("xyz", data.box_bounds):
        out.append(f"{lo:.10g} {hi:.10g}  {dim}lo {dim}hi")
    if np.any(data.tilt != 0):
        out.append(f"{data.tilt[0]:.10g} {data.tilt[1]:.10g} "
                   f"{data.tilt[2]:.10g} xy xz yz")
    out += ["", "Masses", ""]
    for t in range(ntypes):
        out.append(f"{t + 1} {data.masses_by_type[t]:.9g}")
    out += ["", "Atoms", ""]
    for a in range(n):
        x, y, z = data.positions[a]
        out.append(f"{a + 1}\t{data.species[a] + 1}\t{x:.10g}\t{y:.10g}"
                   f"\t{z:.10g}")
    if data.velocities is not None:
        out += ["", "Velocities", ""]
        for a in range(n):
            vx, vy, vz = data.velocities[a]
            out.append(f"{a + 1}\t{vx:.10g}\t{vy:.10g}\t{vz:.10g}")
    if has_bonds:
        out += ["", "Bonds", ""]
        for k, (bt, i, j) in enumerate(data.bonds):
            out.append(f"{k + 1}\t{bt}\t{i + 1}\t{j + 1}")
    if data.per_atom_mass is not None:
        out += ["", "Hmrmass", ""]
        for a in range(n):
            out.append(f"{a + 1}\t{data.per_atom_mass[a]:.10g}")
    Path(path).write_text("\n".join(out) + "\n")


def replicate(data: LammpsData, nx: int, ny: int, nz: int) -> LammpsData:
    """LAMMPS `replicate nx ny nz`: velocities and per-atom masses tiled;
    bonds (of the JAX package's replicate) not carried."""
    h = data.box_h
    reps, vels = [], []
    for ix in range(nx):
        for iy in range(ny):
            for iz in range(nz):
                shift = ix * h[0] + iy * h[1] + iz * h[2]
                reps.append(data.positions + shift)
                if data.velocities is not None:
                    vels.append(data.velocities)
    factor = nx * ny * nz
    bounds = data.box_bounds.copy()
    for d, f in enumerate((nx, ny, nz)):
        lo = bounds[d, 0]
        bounds[d, 1] = lo + (bounds[d, 1] - lo) * f
    return LammpsData(
        species=np.tile(data.species, factor),
        positions=np.concatenate(reps), masses_by_type=data.masses_by_type,
        box_bounds=bounds, tilt=data.tilt * np.array([ny, nz, nz]),
        velocities=np.concatenate(vels) if vels else None,
        per_atom_mass=(np.tile(data.per_atom_mass, factor)
                       if data.per_atom_mass is not None else None))
