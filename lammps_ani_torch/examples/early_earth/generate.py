"""Generate an early-earth (Miller-Urey) mixture box.

Counterpart of examples/early_earth/generate.py: water with CH4, NH3, CO
and H2 (one each per 12 waters) as rigid molecules on a jittered lattice
(`examples._placement.place`), the same arrays bit for bit for the same
arguments, written by the port's `io.lammps_data.write_lammps_data` (the
same bytes after the writer's comment line). `build(12000)` gives the
49,000 atoms of examples/early_earth/early_earth_50k.data.

    python -m lammps_ani_torch.examples.early_earth.generate \
        [n_water] [out.data]

Default 480 H2O + reactants (1,960 atoms) at 0.9 g/cm^3, seed 11.
"""

from __future__ import annotations

import sys

import numpy as np

from ...io.lammps_data import LammpsData, write_lammps_data
from .._placement import cube_edge, place

# ANI species indices: H=0, C=1, N=2, O=3
MASSES = np.array([1.008, 12.0107, 14.0067, 15.999])

H2O = dict(species=np.array([3, 0, 0], np.int32),
           pos=np.array([[0.0, 0.0, 0.0], [0.9572, 0.0, 0.0],
                         [-0.24, 0.9266, 0.0]]))
CH4 = dict(species=np.array([1, 0, 0, 0, 0], np.int32),
           pos=np.array([[0.0, 0.0, 0.0], [0.629, 0.629, 0.629],
                         [-0.629, -0.629, 0.629], [-0.629, 0.629, -0.629],
                         [0.629, -0.629, -0.629]]))
NH3 = dict(species=np.array([2, 0, 0, 0], np.int32),
           pos=np.array([[0.0, 0.0, 0.0], [0.9377, 0.0, 0.0],
                         [-0.3816, 0.8565, 0.0],
                         [-0.3816, -0.3792, 0.768]]))
CO = dict(species=np.array([1, 3], np.int32),
          pos=np.array([[0.0, 0.0, 0.0], [1.128, 0.0, 0.0]]))
H2 = dict(species=np.array([0, 0], np.int32),
          pos=np.array([[0.0, 0.0, 0.0], [0.741, 0.0, 0.0]]))


def build(n_water: int = 480, density_g_cm3: float = 0.9,
          seed: int = 11) -> LammpsData:
    """n_water H2O and n_water // 12 (at least 1) each of CH4, NH3, CO
    and H2 in a cube of the given density."""
    n_r = max(1, n_water // 12)
    mols = ([H2O] * n_water + [CH4] * n_r + [NH3] * n_r + [CO] * n_r
            + [H2] * n_r)
    mass = n_water * 18.015 + n_r * (16.04 + 17.03 + 28.01 + 2.016)
    return place(mols, cube_edge(mass, density_g_cm3), 0.15, seed, MASSES)


def main(argv=None) -> LammpsData:
    argv = sys.argv[1:] if argv is None else argv
    n_water = int(argv[0]) if len(argv) > 0 else 480
    out = argv[1] if len(argv) > 1 else "early_earth.data"
    data = build(n_water)
    write_lammps_data(out, data)
    print(f"wrote {out}: {data.n_atoms} atoms, box "
          f"{data.box_bounds[0, 1]:.2f} A")
    return data


if __name__ == "__main__":
    main()
