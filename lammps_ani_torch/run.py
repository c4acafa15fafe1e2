"""Config-driven MD runner (CLI).

Port of lammps_ani_tpu/run.py:

    python -m lammps_ani_torch.run config.json [--key value overrides]
    python -m lammps_ani_torch.run --data water.data --model ani2x \
        --steps 1000 --dt 0.5 --ensemble nvt --temp 300 --device cpu
    torchrun --nproc_per_node N -m lammps_ani_torch.run config.json \
        --mesh_shape PX PY PZ

Config keys (JSON / CLI flags), the JAX CLI's:
    data (path), model (ani2x|ani1x_nr|path.npz), num_models, cutoff, skin,
    rebuild_every, dt, steps, ensemble (nve|nvt|npt|langevin), temp, tdamp,
    press, pdamp, seed, precision (single|double), replicate [nx,ny,nz],
    hmr_factor, thermo_every, dump (path), dump_every, dump_format
    (lammpstrj|xyz|dcd), restart (path), restart_every, read_restart (path),
    minimize_first (bool), log (path), mesh_shape [px,py,pz]
and one more, `device`: the torch device to run on (default: the card;
`cpu` runs the plain PyTorch path).

The engine is `Simulation`'s default (the mirror engine), sized as the
JAX CLI sizes it. Langevin draws from a generator on the run's device
seeded with `seed`.

`mesh_shape` routes the same config through the sharded engine (the JAX
CLI's `_main_sharded`): `parallel.sim.DomainSimulation`, capacities from
`parallel.domain.auto_domain_spec` at the engine's neighbor radius
max(cutoff, Rcr) + skin. Under `torchrun` (RANK, WORLD_SIZE and
LOCAL_RANK set) each process holds one shard of a process group
(`parallel.comm.ProcessGroupMesh`): NCCL on the card `cuda:LOCAL_RANK`,
gloo with `--device cpu`; the world size must be px * py * pz. Without
`torchrun` every shard runs in this process (`LocalMesh`). Rank 0 alone
prints and writes the log, the dumps and the restarts; every rank reads
the data and a restart. `minimize_first` is refused there, as the JAX CLI
refuses it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from . import Box, NeighborConfig, Simulation
from ._device import resolve_device
from .io import dump as dumpio
from .io import lammps_data as ldio
from .io import restart as restio
from .md import integrate
from .md import minimize as minmod
from .models import zoo
from .parallel import domain as pdomain
from .parallel.comm import ProcessGroupMesh
from .parallel.sim import DomainSimulation
from .tools import hmr as hmrmod

DEFAULTS = dict(
    model="ani2x", num_models=1, cutoff=5.1, skin=2.0, rebuild_every=10,
    dt=0.5, steps=100, ensemble="nve", temp=300.0, tdamp=100.0, press=1.0,
    pdamp=1000.0, seed=12345, precision="single", replicate=None,
    hmr_factor=None, thermo_every=50, dump=None, dump_every=100,
    dump_format="lammpstrj", restart=None, restart_every=0,
    read_restart=None, minimize_first=False, log=None, mesh_shape=None,
    device=None,
)

FIELDS = "step pe ke etotal temp press vol density".split()
# a collective of the mesh_shape route that waits longer than this raises
PG_TIMEOUT_S = 120


def load_config(argv):
    cfg = dict(DEFAULTS)
    parser = argparse.ArgumentParser(prog="lammps_ani_torch.run")
    parser.add_argument("config", nargs="?", help="JSON config file")
    for k, v in DEFAULTS.items():
        t = type(v) if v is not None else str
        if t is bool:
            parser.add_argument(f"--{k}", type=lambda s: s.lower() == "true")
        elif k in ("replicate", "mesh_shape"):
            parser.add_argument(f"--{k}", type=int, nargs=3)
        else:
            parser.add_argument(f"--{k}", type=t)
    parser.add_argument("--data", type=str)
    args = parser.parse_args(argv)
    if args.config:
        cfg.update(json.loads(Path(args.config).read_text()))
    for k, v in vars(args).items():
        if k != "config" and v is not None:
            cfg[k] = v
    if not cfg.get("data"):
        parser.error("--data (or config['data']) is required")
    return cfg


def _round8(x) -> int:
    return -(-int(x) // 8) * 8


def build(cfg, mesh=None):
    """(engine, LammpsData, Box) of a config: `Simulation`, or with
    `mesh_shape` a `DomainSimulation` (on `mesh`, `LocalMesh` where
    None)."""
    device = resolve_device(cfg["device"])
    dtype = torch.float64 if cfg["precision"] == "double" else torch.float32
    data = ldio.read_lammps_data(cfg["data"])
    if cfg["replicate"]:
        data = ldio.replicate(data, *cfg["replicate"])
    if cfg["hmr_factor"]:
        data = hmrmod.apply_hmr(data, cfg["hmr_factor"])

    model = cfg["model"]
    if model in zoo.all_models:
        pot = zoo.all_models[model](num_models=cfg["num_models"],
                                    dtype=dtype, device=device)
    else:
        pot = zoo.load_potential(model, dtype=dtype, device=device)
        if cfg["num_models"] > 0:
            pot = pot.select_models(cfg["num_models"])

    ens = cfg["ensemble"]
    integrator = None
    if ens == "nvt":
        integrator = integrate.NoseHoover(temp=cfg["temp"],
                                          tdamp=cfg["tdamp"])
    elif ens == "langevin":
        gen = torch.Generator(device=device).manual_seed(cfg["seed"])
        integrator = integrate.Langevin(temp=cfg["temp"], damp=cfg["tdamp"],
                                        generator=gen)
    elif ens == "npt":
        integrator = integrate.NoseHooverNPT(
            temp=cfg["temp"], tdamp=cfg["tdamp"],
            press=cfg["press"], pdamp=cfg["pdamp"])
    elif ens != "nve":
        raise ValueError(f"unknown ensemble {ens!r}")

    n = data.n_atoms
    box = Box.from_lammps(*data.box_bounds.ravel(), *data.tilt, dtype=dtype,
                          device=device)
    # density-derived capacity starting points (run()'s regrows own
    # correctness; these avoid the first ones)
    box_h = box.h.detach().cpu().numpy().astype(np.float64)
    density = n / float(abs(np.linalg.det(box_h)))
    if cfg["mesh_shape"]:
        rlist = max(cfg["cutoff"], pot.spec.cutoff) + cfg["skin"]
        dspec = pdomain.auto_domain_spec(
            n, box_h, tuple(cfg["mesh_shape"]), rlist,
            k_max=_round8(4.19 * rlist ** 3 * density * 1.3 + 8))
        sim = DomainSimulation(
            pot, dspec, cutoff=cfg["cutoff"], skin=cfg["skin"],
            rebuild_every=cfg["rebuild_every"], dt=cfg["dt"],
            integrator=integrator, dtype=dtype, device=device, mesh=mesh)
        return sim, data, box
    rlist = cfg["cutoff"] + cfg["skin"]
    k_max = _round8(4.19 * rlist ** 3 * density * 1.3 + 8)
    cell_cap = _round8(rlist ** 3 * density * 2.0 + 4)
    sim = Simulation(
        potential=pot, species=data.species, masses=data.atom_masses,
        nbr=NeighborConfig(
            cutoff=cfg["cutoff"], skin=cfg["skin"], k_max=k_max,
            ghost_capacity=max(2048, n), rebuild_every=cfg["rebuild_every"],
            use_cell_list=n > 2000, cell_capacity=cell_cap),
        dt=cfg["dt"], integrator=integrator, dtype=dtype, device=device)
    return sim, data, box


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    cfg = load_config(argv if argv is not None else sys.argv[1:])
    if cfg["mesh_shape"]:
        return _main_sharded(cfg)
    sim, data, box = build(cfg)
    if cfg["read_restart"]:
        state = restio.load_restart(cfg["read_restart"], sim)
    else:
        state = sim.init_state(
            data.positions, box, vel=data.velocities,
            temp=cfg["temp"] if data.velocities is None else None,
            seed=cfg["seed"])

    if cfg["minimize_first"]:
        state, info = minmod.minimize(sim, state)
        print(f"# minimize: {info}")

    def frame(st):
        return sim.positions_input_order(st), sim.species_np[sim.inv_order]

    return _drive(cfg, state, sim.run, sim.n_atoms, frame,
                  lambda st: restio.save_restart(cfg["restart"], sim, st),
                  sim.device)


@contextlib.contextmanager
def torchrun_mesh(mesh_shape, device=None):
    """(mesh, device) of the `mesh_shape` route. Under torchrun (RANK,
    WORLD_SIZE and LOCAL_RANK set): a `ProcessGroupMesh` of one shard a
    rank on a process group made here (NCCL on the card `cuda:LOCAL_RANK`,
    gloo on the CPU) and that device; the group is destroyed on the way
    out, also after an exception. Otherwise (None, `device` as given):
    the caller runs every shard in this process on `LocalMesh`."""
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "LOCAL_RANK")):
        yield None, device
        return
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        timeout=timedelta(seconds=PG_TIMEOUT_S),
        device_id=device if device.type == "cuda" else None)
    try:
        yield ProcessGroupMesh(mesh_shape, device=device), device
    finally:
        dist.destroy_process_group()


def _main_sharded(cfg):
    """The `mesh_shape` route: under torchrun one shard a rank, else every
    shard in this process."""
    if cfg["minimize_first"]:
        raise ValueError("minimize_first is not supported with mesh_shape")
    with torchrun_mesh(cfg["mesh_shape"], cfg["device"]) as (mesh, device):
        return _run_sharded(cfg if mesh is None
                            else {**cfg, "device": str(device)}, mesh)


def _run_sharded(cfg, mesh):
    dsim, data, box = build(cfg, mesh)
    if cfg["read_restart"]:
        state = dsim.load_restart(cfg["read_restart"])
    else:
        state = dsim.init_state(
            data.species, data.atom_masses, data.positions, box,
            vel=data.velocities,
            temp=cfg["temp"] if data.velocities is None else None,
            seed=cfg["seed"])
    return _drive(cfg, state, dsim.run, dsim.n_global,
                  lambda st: (dsim.gather(st, "pos"), data.species),
                  lambda st: dsim.save_restart(cfg["restart"], st),
                  dsim.device, rank0=dsim.mesh.rank == 0)


def _drive(cfg, state, run, n_atoms, frame, save, device, rank0=True):
    """The run loop of both routes: chunks that stop at every output
    boundary (the NEAREST next dump or restart multiple), the thermo, the
    frames, the restarts and the `Performance:` line. `frame(state)` and
    `save(state)` run on every rank (they gather); rank 0 alone prints
    and writes."""
    writer = None
    if cfg["dump"] and rank0:
        syms = ["H", "C", "N", "O", "S", "F", "Cl"]
        cls = {"lammpstrj": lambda p: dumpio.LammpsTrjWriter(p, syms),
               "xyz": lambda p: dumpio.XYZWriter(p, syms),
               "dcd": lambda p: dumpio.DCDWriter(p, n_atoms, cfg["dt"],
                                                 cfg["dump_every"])}
        writer = cls[cfg["dump_format"]](cfg["dump"])

    log = dumpio.ThermoLog(cfg["log"] if rank0 else None)
    if rank0:
        print("# " + " ".join(f"{f:>12}" for f in FIELDS))
    base_step = {"v": 0}

    def on_thermo(row):
        row = dict(row)
        row["step"] += base_step["v"]  # chunk-local -> absolute step
        log(row)
        if rank0:
            print("  " + " ".join(f"{row.get(f, float('nan')):12.4f}"
                                  for f in FIELDS))

    steps = cfg["steps"]
    done = 0
    _sync(device)
    t0 = time.perf_counter()
    cadences = [c for c in (cfg["dump_every"] if cfg["dump"] else 0,
                            cfg["restart_every"] if cfg["restart"] else 0)
                if c]
    while done < steps:
        nxt = (min((done // c + 1) * c for c in cadences) if cadences
               else steps)
        take = min(nxt, steps) - done
        base_step["v"] = done
        state, _ = run(state, take, thermo_every=cfg["thermo_every"],
                       thermo_callback=on_thermo)
        done += take
        if cfg["dump"] and done % cfg["dump_every"] == 0:
            pos, species = frame(state)
            if writer:
                writer.write_frame(int(state.step), pos, species,
                                   state.box.h.detach().cpu().numpy(),
                                   state.box.origin.detach().cpu().numpy())
        if cfg["restart"] and cfg["restart_every"] and \
                done % cfg["restart_every"] == 0:
            save(state)
    _sync(device)
    wall = time.perf_counter() - t0
    ms = wall / max(steps, 1) * 1e3
    nsday = cfg["dt"] * 86.4 / ms
    if rank0:
        print(f"# Performance: {nsday:.4f} ns/day, {1e3 / ms:.3f} "
              f"timesteps/s, {n_atoms * 1e-6 * 1e3 / ms:.4f} Matom-step/s")
    if writer:
        writer.close()
    log.close()
    if cfg["restart"]:
        save(state)
    return state


if __name__ == "__main__":
    main()
