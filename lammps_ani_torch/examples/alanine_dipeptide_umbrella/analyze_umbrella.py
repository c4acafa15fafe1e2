"""PMF from umbrella windows via WHAM.

Counterpart of examples/alanine-dipeptide-umbrella/analyze_umbrella.py:
the windows of `run_umbrella` (an npz of `centers` and `w0`, `w1`, ...)
through `analysis.wham.wham` at run_umbrella's k (40 kcal/mol/rad^2) and
300 K over a periodic CV (2 pi).

    python -m lammps_ani_torch.examples.alanine_dipeptide_umbrella.analyze_umbrella \
        [umbrella_samples.npz]

Prints the phi PMF as (angle, kcal/mol) rows.
"""

from __future__ import annotations

import sys

import numpy as np

from ...analysis.wham import wham

K = 40.0
TEMP = 300.0


def pmf(path="umbrella_samples.npz"):
    """(bin centers, PMF kcal/mol, window free energies) of the file's
    windows."""
    with np.load(path) as z:
        centers = z["centers"]
        samples = [z[f"w{i}"] for i in range(len(centers))]
    return wham(samples, centers, k=K, temp=TEMP, periodic=2 * np.pi)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    x, p, f = pmf(argv[0] if argv else "umbrella_samples.npz")
    print("# phi_rad  pmf_kcal_mol")
    for xi, pi in zip(x, p):
        print(f"{xi:8.4f}  {pi:10.4f}")
    return x, p, f


if __name__ == "__main__":
    main()
