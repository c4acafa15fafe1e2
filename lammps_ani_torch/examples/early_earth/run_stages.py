"""Staged early-earth campaign on the sharded engine.

Counterpart of examples/early_earth/run_stages.py (the reference's staged
temperature protocol with a restart between stages): ANI-1xnr with
`num_models` models in f32 on `parallel.sim.DomainSimulation`, whose
default engine on the card in f32 is the asn kernels on brick bins (on
the CPU the mirror-ext engine).

    python -m lammps_ani_torch.examples.early_earth.run_stages \
        [config.json] [--device cpu] [--first_stage I]
    torchrun --nproc_per_node 8 \
        -m lammps_ani_torch.examples.early_earth.run_stages config.json

The config keys are the JAX script's (`DEFAULTS`), with two more: `device`
(as the CLI takes it; `--device` overrides it) and `log` (a thermo YAML of
every stage's rows at the campaign's step, as the CLI's `log`). A relative
`data` path is read from the working directory.

The protocol is the JAX script's:

  * capacities from `parallel.domain.auto_domain_spec` where `auto_spec`
    is set, else `DomainSpec(n_cap, halo_cap, mig_cap, k_max)`;
  * `NoseHoover(T, tdamp)` set per stage, the chain's state carried from
    stage to stage (the engine reads its integrator at every chunk, so the
    assignment between `run` calls takes effect at once: the JAX script's
    cache clear has no counterpart); velocities drawn at the first stage's
    temperature with seed 2026;
  * each stage `run(state, steps, thermo_every)`, its thermo lines in the
    JAX format, then `f"{restart_prefix}{i}.npz"` through
    `DomainSimulation.save_restart` (the JAX keys, and the layout and
    sizing with which `first_stage=i + 1` resumes the campaign bit for
    bit);
  * after the last stage: the total energy finite and every atom's id
    present exactly once (a RuntimeError naming the counts otherwise),
    then the top 10 formulas of `analysis.fragments` over the gathered
    positions.

`auto_spec` sizes the capacities at `DomainSimulation.rlist`, max(cutoff,
Rcr) + skin, as the port's CLI does. The JAX script sizes them at cutoff
+ skin: for config_50k (ANI-1xnr, Rcr 5.2, cutoff 5.1, skin 1.0) 6.1 A
where the engine's radius is 6.2 A, the JAX sharded engine's neighbor
radius fault (its rlist stops short of Rcr), which the port does not
repeat.

Under `torchrun` (RANK, WORLD_SIZE and LOCAL_RANK set) each process holds
one shard of a process group (`run.torchrun_mesh`: NCCL on
`cuda:LOCAL_RANK`, gloo with device cpu; the world size must be px * py *
pz); otherwise every shard runs in this process (`LocalMesh`). Rank 0
alone prints and writes.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import sys
import time
from collections import Counter
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..._device import resolve_device
from ...analysis.fragments import fragments
from ...io.dump import ThermoLog
from ...io.lammps_data import read_lammps_data
from ...md import integrate
from ...models import zoo
from ...ops.neighbors import Box
from ...parallel.domain import DomainSpec, auto_domain_spec
from ...parallel.sim import DomainSimulation, ShardedState
from ...run import torchrun_mesh

DEFAULTS = {
    "data": "early_earth.data",
    "mesh_shape": [2, 2, 2],
    "n_cap": 512,
    "halo_cap": [768, 1024, 2048],
    "mig_cap": 128,
    "k_max": 96,
    "num_models": 1,
    "cutoff": 5.1,
    "skin": 1.0,
    "rebuild_every": 10,
    "dt": 0.25,
    "tdamp": 50.0,
    # staged protocol: (temperature K, steps) per stage; the production
    # campaign uses 200k-step stages; the engine regrows capacities
    # instead of dying
    "stages": [[300.0, 40], [500.0, 40], [750.0, 40]],
    "thermo_every": 10,
    "restart_prefix": "early_earth.stage",
    "device": None,
    "log": None,
}
VELOCITY_SEED = 2026
TOP_FRAGMENTS = 10


@dataclasses.dataclass
class Campaign:
    """What `run_campaign` leaves: the engine and its final state, each
    stage's thermo rows (steps within the stage, as `run` gives them) and
    seconds, and the final fragments (formula, count), most common first
    (rank 0's; empty on the other ranks)."""

    dsim: DomainSimulation
    state: ShardedState
    rows: list
    seconds: list
    fragments: list


def load_config(path=None) -> dict:
    """`DEFAULTS` updated from a JSON file."""
    cfg = dict(DEFAULTS)
    if path is not None:
        cfg.update(json.loads(Path(path).read_text()))
    return cfg


def make_engine(cfg, n_atoms: int, box_h, device, mesh=None,
                dtype=torch.float32) -> DomainSimulation:
    """The campaign's engine: ANI-1xnr with `num_models` models, the
    config's capacities, NoseHoover at the first stage's temperature."""
    pot = zoo.ani1xnr(num_models=int(cfg["num_models"]), dtype=dtype,
                      device=device)
    mesh_shape = tuple(cfg["mesh_shape"])
    cutoff, skin = float(cfg["cutoff"]), float(cfg["skin"])
    if cfg.get("auto_spec"):
        rlist = max(cutoff, pot.spec.cutoff) + skin  # DomainSimulation.rlist
        dspec = auto_domain_spec(n_atoms, box_h, mesh_shape, rlist,
                                 k_max=int(cfg["k_max"]))
    else:
        dspec = DomainSpec(mesh_shape=mesh_shape, n_cap=int(cfg["n_cap"]),
                           halo_cap=tuple(cfg["halo_cap"]),
                           mig_cap=int(cfg["mig_cap"]),
                           k_max=int(cfg["k_max"]))
    return DomainSimulation(
        pot, dspec, cutoff=cutoff, skin=skin,
        rebuild_every=int(cfg["rebuild_every"]), dt=float(cfg["dt"]),
        integrator=stage_integrator(cfg, 0), dtype=dtype, device=device,
        mesh=mesh)


def stage_integrator(cfg, i: int) -> integrate.NoseHoover:
    return integrate.NoseHoover(temp=float(cfg["stages"][i][0]),
                                tdamp=float(cfg["tdamp"]))


def thermo_line(r: dict) -> str:
    """A thermo row as the JAX script prints it."""
    return (f"  step {r['step']:>8} pe {r['pe']:.1f} T {r['temp']:7.1f} "
            f"etot {r['etotal']:.1f}")


def check_invariants(dsim: DomainSimulation, state: ShardedState,
                     rows: list) -> int:
    """The end-of-campaign invariants: the last row's total energy finite
    and every atom's id present exactly once over the mesh (collective:
    every rank checks the same layout). Returns the atom count; raises a
    RuntimeError naming the counts otherwise."""
    etotal = rows[-1]["etotal"] if rows else math.nan
    if not math.isfinite(etotal):
        raise RuntimeError(f"the total energy is not finite: {rows[-1:]}")
    gid = dsim.layout(state)
    got = np.sort(gid[gid >= 0])
    n = dsim.n_global
    if not np.array_equal(got, np.arange(n)):
        counts = np.bincount(got, minlength=n)
        raise RuntimeError(
            f"migration lost or duplicated atoms: {len(got)} ids held for "
            f"{n} atoms, {int((counts == 0).sum())} missing, "
            f"{int((counts > 1).sum())} held more than once")
    return n


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_campaign(cfg: dict, device=None, mesh=None, log: Callable = print,
                 dtype=torch.float32, first_stage: int = 0) -> Campaign:
    """Run the config's stages from `first_stage` on (0: from the data
    file; i > 0: from stage i - 1's restart). `device`: the card unless
    given (a given `mesh` brings its own); `log` takes each printed line
    (rank 0 alone prints)."""
    if not 0 <= first_stage < len(cfg["stages"]):
        raise ValueError(f"first_stage {first_stage}: the config has "
                         f"{len(cfg['stages'])} stages")
    device = mesh.device if mesh is not None else resolve_device(device)
    data = read_lammps_data(cfg["data"])
    dsim = make_engine(cfg, data.n_atoms, data.box_h, device, mesh, dtype)
    say = log if dsim.mesh.rank == 0 else (lambda line: None)
    thermo_log = ThermoLog(cfg.get("log") if dsim.mesh.rank == 0 else None)
    base = sum(int(st[1]) for st in cfg["stages"][:first_stage])
    if first_stage == 0:
        box = Box(h=torch.as_tensor(data.box_h, dtype=dtype, device=device),
                  origin=torch.as_tensor(data.box_origin, dtype=dtype,
                                         device=device))
        state = dsim.init_state(data.species, data.atom_masses,
                                data.positions, box,
                                temp=float(cfg["stages"][0][0]),
                                seed=VELOCITY_SEED)
    else:
        state = dsim.load_restart(
            f"{cfg['restart_prefix']}{first_stage - 1}.npz")
    stage_rows, seconds = [], []
    try:
        for i in range(first_stage, len(cfg["stages"])):
            temp, steps = cfg["stages"][i]
            dsim.integrator = stage_integrator(cfg, i)
            say(f"# stage {i}: T={temp} K, {steps} steps")

            def on_row(r, base=base):
                say(thermo_line(r))
                thermo_log({**r, "step": base + r["step"]})

            _sync(device)
            t0 = time.perf_counter()
            state, rows = dsim.run(state, int(steps),
                                   thermo_every=int(cfg["thermo_every"]),
                                   thermo_callback=on_row)
            _sync(device)
            seconds.append(time.perf_counter() - t0)
            stage_rows.append(rows)
            base += int(steps)
            path = f"{cfg['restart_prefix']}{i}.npz"
            dsim.save_restart(path, state)
            say(f"# wrote {path}")
    finally:
        thermo_log.close()

    n = check_invariants(dsim, state, stage_rows[-1])
    say(f"# invariants OK: etotal finite, {n} atoms conserved")
    pos = dsim.gather(state, "pos")
    top = []
    if dsim.mesh.rank == 0:
        _, formulas = fragments(data.species, pos,
                                state.box.h.detach().cpu().numpy(),
                                device=device)
        top = Counter(formulas).most_common(TOP_FRAGMENTS)
        say("# final fragments: " + " ".join(f"{f}:{c}" for f, c in top))
    return Campaign(dsim=dsim, state=state, rows=stage_rows,
                    seconds=seconds, fragments=top)


def main(argv=None) -> Campaign:
    parser = argparse.ArgumentParser(
        prog="lammps_ani_torch.examples.early_earth.run_stages")
    parser.add_argument("config", nargs="?", help="JSON config file")
    parser.add_argument("--device", help="torch device (default: the card)")
    parser.add_argument("--first_stage", type=int, default=0,
                        help="resume from the restart of the stage before")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    cfg = load_config(args.config)
    if args.device is not None:
        cfg["device"] = args.device
    log = functools.partial(print, flush=True)
    with torchrun_mesh(cfg["mesh_shape"], cfg["device"]) as (mesh, device):
        return run_campaign(cfg, device=device, mesh=mesh, log=log,
                            first_stage=args.first_stage)


if __name__ == "__main__":
    main()
