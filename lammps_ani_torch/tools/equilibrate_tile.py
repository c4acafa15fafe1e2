"""Equilibrate a small periodic tile under the synthetic ANI-2x PES.

The port's counterpart of tools/equilibrate_tile.py. A benchmark box is a
tile replicated many times; replication keeps each atom's neighbor
environment (the tile's periodic images become real copies), so a tile
equilibrated at 300 K replicates into a large box that starts at
equilibrium. The same work as the JAX tool: ANI-2x with the XTB repulsion
term, one model, the port's synthetic weights (seed 0), f32 on the
default (mirror) engine, velocities and noise from seed 7; FIRE (200
steps, ftol 1 kcal/mol/A), a fresh `init_state` at 300 K, then `--legs`
Langevin legs of `--steps` steps (300 K, damp 20 fs, dt 0.25 fs). It
writes positions, velocities, box_h, box_origin and temp (the last
leg's) to OUT as an .npz.

Usage (on the card unless --device says otherwise):

    python -m lammps_ani_torch.tools.equilibrate_tile water.data out.npz \\
        [--legs 8] [--steps 500] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import Box, NeighborConfig, Simulation
from ..io.lammps_data import read_lammps_data
from ..md import integrate, minimize
from ..models import zoo

SEED = 7


def equilibrate(data_path, out_path, legs: int = 8, steps: int = 500,
                device=None, log=print) -> dict:
    """Relax and thermalize the tile of `data_path`; write `out_path`.
    Returns what was written."""
    data = read_lammps_data(data_path)
    pot = zoo.ani2x(num_models=1, dtype=torch.float32, device=device,
                    repulsion=True)
    sim = Simulation(
        potential=pot, species=data.species, masses=data.atom_masses,
        nbr=NeighborConfig(cutoff=5.1, skin=2.0, ang_skin=2.0, k_max=128,
                           ghost_capacity=1024, rebuild_every=5),
        dt=0.25, dtype=torch.float32, device=device,
        integrator=integrate.Langevin(temp=300.0, damp=20.0))
    gen = torch.Generator(device=sim.device).manual_seed(SEED)
    sim.integrator.generator = gen
    box = Box(h=torch.tensor(data.box_h, dtype=torch.float32),
              origin=torch.tensor(data.box_origin, dtype=torch.float32))
    st = sim.init_state(data.positions, box, temp=300.0, seed=SEED)
    st, info = minimize.minimize(
        sim, st, max_steps=200, ftol=1.0,
        config=minimize.FireConfig(dt_start=0.05, dt_max=0.25))
    log(f"FIRE: fmax {info['fmax']:.3f} pe {info['pe']:.2f}")
    st = sim.init_state(sim.positions_input_order(st), st.box, temp=300.0,
                        seed=SEED)
    row = None
    for leg in range(legs):
        st, rows = sim.run(st, steps, thermo_every=steps)
        row = rows[-1]
        log(f"leg {leg}: temp {row['temp']:8.1f} pe {row['pe']:12.2f} "
            f"press {row['press']:10.1f}")
    out = dict(positions=sim.positions_input_order(st),
               velocities=sim.velocities_input_order(st),
               box_h=st.box.h.detach().cpu().numpy(),
               box_origin=st.box.origin.detach().cpu().numpy(),
               temp=np.nan if row is None else row["temp"])
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, **out)
    log(f"wrote {out_path}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("data", help="LAMMPS data file of the tile")
    p.add_argument("out", help="output .npz path")
    p.add_argument("--legs", type=int, default=8)
    p.add_argument("--steps", type=int, default=500,
                   help="Langevin steps per leg")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    a = p.parse_args(argv)
    equilibrate(a.data, a.out, legs=a.legs, steps=a.steps, device=a.device)


if __name__ == "__main__":
    main()
