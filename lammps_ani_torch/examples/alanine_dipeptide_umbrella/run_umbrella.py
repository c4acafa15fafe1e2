"""Umbrella sampling over a dihedral CV.

Counterpart of examples/alanine-dipeptide-umbrella/run_umbrella.py (the
reference's per-window PLUMED runs): one window per center, run one after
another through `md.bias.run_windows` on the single-device `Simulation`,
with the JAX script's settings: ANI-2x with one model in f32, the
neighbor settings below, dt 0.5 fs, Langevin 300 K (damp 100 fs), a
harmonic restraint on `bias.dihedral_cv` (periodic 2 pi) as `extra_force`,
24 centers over [-pi, pi), k 40 kcal/mol/rad^2, 2,000 steps a window, a
sample every 20. The samples go to an npz of `centers` and `w0`, `w1`,
... (what `analyze_umbrella` reads).

    python -m lammps_ani_torch.examples.alanine_dipeptide_umbrella.run_umbrella \
        system.data [--out umbrella_samples.npz] [--device cpu]

The data file is required: the JAX script's alanine-dipeptide file is not
in the repository. The CV's atoms are `PHI` (input order). The Langevin
noise comes from one generator on the run's device seeded with `SEED`
(the window velocities from SEED + window, as `run_windows` draws them).
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np
import torch

from ..._device import resolve_device
from ...io.lammps_data import LammpsData, read_lammps_data
from ...md import bias, integrate
from ...md.simulation import NeighborConfig, Simulation
from ...models import zoo
from ...models.potential import ANIPotential
from ...ops.neighbors import Box

PHI = (4, 6, 8, 14)  # dihedral atom indices (input order)
NBR = NeighborConfig(cutoff=5.1, skin=2.0, k_max=160, ghost_capacity=4096,
                     rebuild_every=10)
DT = 0.5
TEMP, DAMP = 300.0, 100.0
SEED = 0


def make_sim(data: LammpsData, pot: ANIPotential, extra_force,
             generator: torch.Generator, device=None) -> Simulation:
    """One window's engine (`run_windows`'s make_sim, with the data, the
    potential and the Langevin generator bound)."""
    return Simulation(
        potential=pot, species=data.species, masses=data.atom_masses,
        nbr=NBR, dt=DT, device=device, extra_force=extra_force,
        integrator=integrate.Langevin(temp=TEMP, damp=DAMP,
                                      generator=generator))


def run_umbrella(data_path, phi=PHI, n_windows: int = 24, k: float = 40.0,
                 steps_per_window: int = 2000, sample_every: int = 20,
                 device=None, out="umbrella_samples.npz"):
    """Run the windows and write their samples to `out` (None: no file).
    Returns (centers, samples)."""
    device = resolve_device(device)
    data = read_lammps_data(data_path)
    pot = zoo.ani2x(num_models=1, device=device)
    generator = torch.Generator(device=device).manual_seed(SEED)
    centers = np.linspace(-np.pi, np.pi, n_windows, endpoint=False)
    box = Box.from_lammps(*data.box_bounds.ravel(), *data.tilt,
                          device=device)
    samples = bias.run_windows(
        functools.partial(make_sim, data, pot, generator=generator,
                          device=device),
        data.positions, box, centers, k=k,
        cv_factory=lambda: bias.dihedral_cv(*phi),
        steps_per_window=steps_per_window, sample_every=sample_every,
        seed=SEED, periodic=2 * np.pi)
    if out is not None:
        np.savez(out, centers=centers,
                 **{f"w{i}": s for i, s in enumerate(samples)})
    return centers, samples


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="lammps_ani_torch.examples.alanine_dipeptide_umbrella."
             "run_umbrella")
    parser.add_argument("data", help="LAMMPS data file of the system")
    parser.add_argument("--out", default="umbrella_samples.npz")
    parser.add_argument("--device", help="torch device (default: the card)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    result = run_umbrella(args.data, device=args.device, out=args.out)
    print(f"wrote {args.out} (WHAM/MBAR-ready)")
    return result


if __name__ == "__main__":
    main()
