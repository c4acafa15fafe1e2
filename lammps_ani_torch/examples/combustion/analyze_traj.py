"""Fragment time series from a combustion trajectory.

Counterpart of examples/combustion/analyze_traj.py: each frame of a DCD
trajectory (`io.dump.read_dcd`) split into bonded fragments by
`analysis.fragments` (element-pair cutoffs, minimum image in the data
file's box), the 8 most common formulas a frame.

    python -m lammps_ani_torch.examples.combustion.analyze_traj \
        [traj.dcd] [system.data] [stride] [--device cpu]

Defaults: combustion.dcd, methane_oxygen.data, every frame; the bond
candidates on the card unless `--device` says otherwise.
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter

import numpy as np

from ...analysis.fragments import fragments
from ...io.dump import read_dcd
from ...io.lammps_data import read_lammps_data

TOP = 8


def formula_rows(traj_path, data_path, stride: int = 1, device=None):
    """[(frame index, [(formula, count), ...] most common first)] of
    every `stride`-th frame."""
    data = read_lammps_data(data_path)
    box_h = np.diag(data.box_bounds[:, 1] - data.box_bounds[:, 0])
    frames = read_dcd(traj_path)
    return [(fi * stride, Counter(fragments(data.species, pos, box_h,
                                            device=device)[1]).most_common(
                                                TOP))
            for fi, pos in enumerate(frames[::stride])]


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(
        prog="lammps_ani_torch.examples.combustion.analyze_traj")
    parser.add_argument("traj", nargs="?", default="combustion.dcd")
    parser.add_argument("data", nargs="?", default="methane_oxygen.data")
    parser.add_argument("stride", nargs="?", type=int, default=1)
    parser.add_argument("--device", help="torch device (default: the card)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    rows = formula_rows(args.traj, args.data, args.stride, args.device)
    print("# frame  formulas")
    for frame, top in rows:
        print(frame, " ".join(f"{f}:{c}" for f, c in top), flush=True)
    return rows


if __name__ == "__main__":
    main()
