"""Trajectory dumps and thermo logging.

Port of lammps_ani_tpu/io/dump.py: the LAMMPS `dump custom` lammpstrj
with element names, `dump dcd` for mdtraj/VMD, xyz, and the YAML thermo
table (`thermo_modify line yaml`), with their readers. Host-side: the
writers take numpy arrays (positions in the caller's atom order). For the
same frames each writer's file is byte for byte the JAX package's, the
DCD title included.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


class LammpsTrjWriter:
    """`dump atom/custom`-style .lammpstrj text trajectory."""

    def __init__(self, path, species_symbols=None):
        self.f = open(path, "w")
        self.symbols = species_symbols

    def write_frame(self, step, pos, species, box_h, box_origin,
                    extra_cols=None):
        n = len(pos)
        lo = np.asarray(box_origin, float)
        h = np.asarray(box_h, float)
        hi = lo + np.diag(h)
        f = self.f
        f.write("ITEM: TIMESTEP\n%d\n" % step)
        f.write("ITEM: NUMBER OF ATOMS\n%d\n" % n)
        if abs(h[1, 0]) + abs(h[2, 0]) + abs(h[2, 1]) > 0:
            f.write("ITEM: BOX BOUNDS xy xz yz pp pp pp\n")
            f.write("%g %g %g\n%g %g %g\n%g %g %g\n" % (
                lo[0], hi[0], h[1, 0], lo[1], hi[1], h[2, 0],
                lo[2], hi[2], h[2, 1]))
        else:
            f.write("ITEM: BOX BOUNDS pp pp pp\n")
            for d in range(3):
                f.write("%g %g\n" % (lo[d], hi[d]))
        cols = "id type x y z" + (" element" if self.symbols else "")
        f.write(f"ITEM: ATOMS {cols}\n")
        for i in range(n):
            row = "%d %d %.6f %.6f %.6f" % (
                i + 1, species[i] + 1, pos[i, 0], pos[i, 1], pos[i, 2])
            if self.symbols:
                row += " " + self.symbols[species[i]]
            f.write(row + "\n")
        f.flush()

    def close(self):
        self.f.close()


class XYZWriter:
    def __init__(self, path, species_symbols):
        self.f = open(path, "w")
        self.symbols = species_symbols

    def write_frame(self, step, pos, species, box_h=None, box_origin=None):
        n = len(pos)
        self.f.write("%d\nstep=%d\n" % (n, step))
        for i in range(n):
            self.f.write("%s %.6f %.6f %.6f\n" % (
                self.symbols[species[i]], pos[i, 0], pos[i, 1], pos[i, 2]))
        self.f.flush()

    def close(self):
        self.f.close()


class DCDWriter:
    """CHARMM/NAMD DCD binary trajectory (mdtraj/VMD-compatible).

    Equivalent of LAMMPS `dump dcd` the reference's examples use for
    mdtraj analysis (SURVEY.md §2.2 Reaction analysis).
    """

    def __init__(self, path, n_atoms, dt_fs=0.5, every=1):
        self.n = n_atoms
        self.f = open(path, "wb")
        self.frames = 0
        self._write_header(dt_fs, every)

    def _write_header(self, dt_fs, every):
        f = self.f
        # block 1: CORD header
        akma = dt_fs / 48.88821291  # fs -> AKMA time units
        hdr = struct.pack(
            "<4s9if10i", b"CORD",
            0,        # nframes (patched on close)
            0,        # first step
            every,    # step interval
            0, 0, 0, 0, 0, 0,
            akma,
            1,        # unit cell present
            0, 0, 0, 0, 0, 0, 0, 0,
            24,       # CHARMM version
        )
        f.write(struct.pack("<i", len(hdr)) + hdr +
                struct.pack("<i", len(hdr)))
        title = b"Created by lammps_ani_tpu".ljust(80)
        blk = struct.pack("<i", 1) + title
        f.write(struct.pack("<i", len(blk)) + blk +
                struct.pack("<i", len(blk)))
        f.write(struct.pack("<iii", 4, self.n, 4))

    def write_frame(self, step, pos, species=None, box_h=None,
                    box_origin=None):
        f = self.f
        if box_h is not None:
            h = np.asarray(box_h, float)
            a, b, c = np.diag(h)
            cell = struct.pack("<6d", a, 90.0, b, 90.0, 90.0, c)
            f.write(struct.pack("<i", 48) + cell + struct.pack("<i", 48))
        pos = np.asarray(pos, np.float32)
        for d in range(3):
            data = pos[:, d].tobytes()
            f.write(struct.pack("<i", len(data)) + data +
                    struct.pack("<i", len(data)))
        self.frames += 1

    def close(self):
        # patch frame count
        self.f.seek(8)
        self.f.write(struct.pack("<i", self.frames))
        self.f.close()


class ThermoLog:
    """YAML-ish thermo table matching the reference's machine-readable
    thermo (tests/in.lammps `thermo_modify line yaml`), plus a plain
    column view."""

    def __init__(self, path=None, fields=("step", "pe", "ke", "etotal",
                                          "temp", "press", "vol", "density")):
        self.fields = list(fields)
        self.rows = []
        self.f = open(path, "w") if path else None
        if self.f:
            self.f.write("---\nkeywords: [%s]\ndata:\n" %
                         ", ".join(self.fields))

    def __call__(self, row: dict):
        self.rows.append(row)
        if self.f:
            vals = ", ".join(repr(row.get(k, float("nan")))
                             for k in self.fields)
            self.f.write(f"  - [{vals}]\n")
            self.f.flush()

    def close(self):
        if self.f:
            self.f.write("...\n")
            self.f.close()


def read_thermo_yaml(path):
    """Parse a ThermoLog/LAMMPS yaml thermo block into a dict of lists."""
    keywords, data = None, []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line.startswith("keywords:"):
            keywords = [k.strip() for k in
                        line.split("[", 1)[1].rstrip("]").split(",")]
        elif line.startswith("- ["):
            vals = [float(v) for v in
                    line[3:].rstrip("]").split(",")]
            data.append(vals)
    cols = {k: [row[i] for row in data] for i, k in enumerate(keywords or [])}
    return cols


def read_dcd(path):
    """[n_frames, n_atoms, 3] float32 positions from a DCD trajectory.

    Reads the subset of CHARMM/NAMD DCD that DCDWriter emits (and LAMMPS
    `dump dcd` produces): CORD header, title block, natoms block, then
    per frame an optional unit-cell block and three coordinate blocks."""
    frames = []
    with open(path, "rb") as f:
        def block():
            raw = f.read(4)
            if len(raw) < 4:
                return None
            (n,) = struct.unpack("<i", raw)
            data = f.read(n)
            f.read(4)  # trailing length
            return data

        hdr = block()
        if hdr is None or hdr[:4] != b"CORD":
            raise ValueError(f"{path}: not a DCD file")
        has_cell = struct.unpack("<i", hdr[44:48])[0] != 0
        block()  # title
        (n_atoms,) = struct.unpack("<i", block())
        while True:
            if has_cell:
                cell = block()
                if cell is None:
                    break
            xyz = []
            for _ in range(3):
                data = block()
                if data is None:
                    return np.asarray(frames, np.float32)
                xyz.append(np.frombuffer(data, np.float32, count=n_atoms))
            frames.append(np.stack(xyz, axis=1))
    return np.asarray(frames, np.float32)
