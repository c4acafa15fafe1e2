"""Generate the combustion starting system (CH4 + 2 O2 mixture).

Counterpart of examples/combustion/prepare_system.py: random rigid
molecules on a jittered lattice (`examples._placement.place`), the same
arrays bit for bit for the same arguments, written as a LAMMPS data file
by the port's `io.lammps_data.write_lammps_data` (the same bytes after
the writer's comment line).

    python -m lammps_ani_torch.examples.combustion.prepare_system \
        [n_ch4] [out.data]

Defaults: 160 CH4 + 320 O2 (1,440 atoms) at 0.25 g/cm^3, seed 7.
"""

from __future__ import annotations

import sys

import numpy as np

from ...io.lammps_data import LammpsData, write_lammps_data
from .._placement import cube_edge, place

CH4 = {
    "species": np.array([1, 0, 0, 0, 0], np.int32),  # C H H H H
    "pos": np.array([
        [0.000, 0.000, 0.000],
        [1.092, 0.000, 0.000],
        [-0.364, 1.017, -0.165],
        [-0.364, -0.366, 0.963],
        [-0.364, -0.651, -0.798],
    ]),
}
O2 = {
    "species": np.array([3, 3], np.int32),
    "pos": np.array([[0.0, 0.0, 0.0], [1.281, 0.0, 0.0]]),
}
MASSES = np.array([1.008, 12.0107, 14.0067, 15.999, 32.06,
                   18.998403163, 35.453])


def build(n_ch4: int = 160, density_g_cm3: float = 0.25,
          seed: int = 7) -> LammpsData:
    """n_ch4 CH4 and 2 n_ch4 O2 in a cube of the given density."""
    n_o2 = 2 * n_ch4
    mols = [CH4] * n_ch4 + [O2] * n_o2
    mass_total = n_ch4 * (12.0107 + 4 * 1.008) + n_o2 * 2 * 15.999  # g/mol
    return place(mols, cube_edge(mass_total, density_g_cm3), 0.18, seed,
                 MASSES)


def main(argv=None) -> LammpsData:
    argv = sys.argv[1:] if argv is None else argv
    n_ch4 = int(argv[0]) if len(argv) > 0 else 160
    out = argv[1] if len(argv) > 1 else "methane_oxygen.data"
    data = build(n_ch4)
    write_lammps_data(out, data)
    print(f"wrote {out}: {data.n_atoms} atoms "
          f"({n_ch4} CH4 + {2 * n_ch4} O2), box "
          f"{data.box_bounds[0, 1]:.2f} A")
    return data


if __name__ == "__main__":
    main()
