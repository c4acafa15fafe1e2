"""The system under test: the port's Simulation on the asn engine.

`build` makes the configuration's potential through the port's factory
with the benchmark's weights, and a `Simulation` with the traffic file's
settings by the user's path (`cellroll=True`: in f32 on the card the
pallas_asn engine, asserted). `warm_up` runs the traffic's relaxation;
`window` runs chunks of `rebuild_every` steps, each ending in
`torch.cuda.synchronize()`, until the seconds have passed, counting every
step and every second, regrows included.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def port_potential(cfg: dict, params, device):
    from lammps_ani_torch.models import zoo

    pot = getattr(zoo, cfg["port"]["factory"])(
        num_models=int(cfg["num_models"]), params=params,
        dtype=torch.float32, device=device, **cfg["port"]["kwargs"])
    check_spec(cfg, pot.spec)
    return pot


def check_spec(cfg: dict, spec):
    """Raise where the port's model differs from the configuration file
    (a constant the reference takes from the file)."""
    a = cfg["aev"]
    got = {k: getattr(spec.aev, k) for k in a}
    want = {k: tuple(v) if isinstance(v, list) else v for k, v in a.items()}
    rep = cfg["repulsion"]
    checks = {
        "aev": (got, want),
        "hidden": (tuple(map(tuple, spec.net.hidden)),
                   tuple(map(tuple, cfg["hidden"]))),
        "celu_alpha": (spec.net.celu_alpha, cfg["celu_alpha"]),
        "self_energies": (tuple(spec.shifter.self_energies),
                          tuple(cfg["self_energies"])),
        "symbols": (tuple(spec.symbols), tuple(cfg["symbols"])),
        "repulsion": ((spec.repulsion.alpha, spec.repulsion.zeff,
                       spec.repulsion.cutoff, spec.repulsion.k_f,
                       spec.repulsion.cutoff_fn),
                      (tuple(rep["alpha"]), tuple(rep["zeff"]),
                       rep["cutoff"], rep["k_f"], rep["cutoff_fn"])),
    }
    for key, (g, w) in checks.items():
        if g != w:
            raise ValueError(f"the port's {key} {g} is not the "
                             f"configuration's {w}")


def integrator(md: dict, generator, **override):
    from lammps_ani_torch.md import integrate

    p = {**md, **override}
    if p["integrator"] == "langevin":
        return integrate.Langevin(temp=p["temp"], damp=p["damp"],
                                  generator=generator)
    if p["integrator"] == "nose_hoover":
        return integrate.NoseHoover(temp=p["temp"], tdamp=p["tdamp"])
    raise ValueError(f"integrator {p['integrator']!r}")


@dataclasses.dataclass
class Run:
    sim: object
    state: object
    generator: object  # the Langevin noise's torch.Generator, or None


def build(cfg: dict, traffic: dict, system, params, seed: int, device):
    """(Run at `init_state`, seconds of `init_state`)."""
    import lammps_ani_torch as lat

    md = traffic["md"]
    n = system.n_atoms
    pot = port_potential(cfg, params, device)
    gen = None
    if "langevin" in [md["integrator"]] + [
            st.get("integrator") for st in traffic["warmup"]]:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    nbr = lat.NeighborConfig(cutoff=md["cutoff"], skin=md["skin"], k_max=128,
                             ghost_capacity=max(4096, n // 2),
                             use_cell_list=n > 4096, cell_capacity=32,
                             rebuild_every=md["rebuild_every"])
    sim = lat.Simulation(potential=pot, species=system.species,
                         masses=system.masses, nbr=nbr, dt=md["dt"],
                         integrator=integrator(md, gen),
                         dtype=torch.float32, device=device,
                         cellroll=md["cellroll"], engine=md.get("engine"))
    if sim.engine != "pallas_asn":
        raise RuntimeError(f"the user's path ran engine {sim.engine!r}, "
                           "not pallas_asn")
    box = lat.Box(h=torch.diag(torch.tensor(system.lengths,
                                            dtype=torch.float64)),
                  origin=torch.tensor(system.origin, dtype=torch.float64))
    t0 = time.perf_counter()
    state = sim.init_state(system.positions, box, temp=md["init_temp"],
                           seed=int(seed))
    sync(device)
    return Run(sim=sim, state=state, generator=gen), time.perf_counter() - t0


def warm_up(run: Run, traffic: dict) -> list:
    """The traffic's relaxation stages ({"chunks", and integrator settings
    that differ from its "md" group}), then the run's own integrator. The
    temperature at each stage's end, K."""
    md = traffic["md"]
    chunk = md["rebuild_every"]
    temps = []
    for stage in traffic["warmup"]:
        over = {k: v for k, v in stage.items() if k != "chunks"}
        run.sim.integrator = integrator(md, run.generator, **over)
        run.state, rows = run.sim.run(run.state, stage["chunks"] * chunk,
                                      thermo_every=md["thermo_every"])
        temps.append(round(float(rows[-1]["temp"]), 1))
    run.sim.integrator = integrator(md, run.generator)
    sync(run.sim.device)
    return temps


@dataclasses.dataclass
class Chunk:
    """A chunk of the window: its input state, the noise generator's state
    before it, and whether the simulation regrew a capacity in it."""

    before: object
    gen_state: object
    regrew: bool
    after: object = None


@dataclasses.dataclass
class Window:
    seconds: float
    steps: int
    regrows: int
    clean: object  # the newest Chunk that regrew nothing, or None
    rows: list  # thermo rows
    traced: object = None  # Traced


@dataclasses.dataclass
class Traced:
    """The profiled chunks of a window (portbench/trace.py)."""

    trace: object  # the device's activity alone: the per-layer metrics
    steps: int  # its steps
    before: object  # the state before them
    after: object  # and after
    gaps: object  # a further chunk traced with the host's operations


def window(run: Run, traffic: dict, seconds: float, trace_chunks=None):
    """Chunks until `seconds` have passed. `trace_chunks` (skip, count,
    gap_chunks): after `skip` chunks, profile `count` chunks with the
    device's activity alone, then `gap_chunks` with the host's operations
    too (portbench/trace.py)."""
    from . import trace as trmod

    md = traffic["md"]
    sim, chunk = run.sim, md["rebuild_every"]
    step0, regrow0 = run.state.step, sim.regrow_events
    clean, rows, traced, k = None, [], None, 0

    def chunks(count):
        st = run.state
        for _ in range(count):
            st, r = sim.run(st, chunk, thermo_every=md["thermo_every"])
            sync(sim.device)
            rows.extend(r)
        return st

    t0 = time.perf_counter()
    while True:
        if trace_chunks and k == trace_chunks[0]:
            _, count, gap_chunks = trace_chunks
            before = run.state
            run.state, tr = trmod.profile(lambda: chunks(count), sim.device)
            after = run.state
            run.state, gaps = trmod.profile(lambda: chunks(gap_chunks),
                                            sim.device, host=True)
            traced = Traced(trace=tr, steps=after.step - before.step,
                            before=before, after=after, gaps=gaps)
            k += count + gap_chunks
        else:
            c = Chunk(before=run.state,
                      gen_state=(None if run.generator is None
                                 else run.generator.get_state()),
                      regrew=False)
            r0 = sim.regrow_events
            run.state, r = sim.run(run.state, chunk,
                                   thermo_every=md["thermo_every"])
            sync(sim.device)
            c.after, c.regrew = run.state, sim.regrow_events != r0
            rows.extend(r)
            if not c.regrew:
                # the check follows it: a regrown chunk drew noise that its
                # rerun replaced
                clean = c
            k += 1
        if time.perf_counter() - t0 >= seconds and (
                not trace_chunks or traced is not None):
            break
    elapsed = time.perf_counter() - t0
    return Window(seconds=elapsed, steps=run.state.step - step0,
                  regrows=sim.regrow_events - regrow0, clean=clean, rows=rows,
                  traced=traced)


def ns_per_day(steps: int, dt_fs: float, seconds: float) -> float:
    """Simulated ns a day of wall time: steps x dt over the window."""
    return steps * dt_fs * 1e-6 * 86400.0 / seconds


def finite(rows) -> bool:
    return all(np.isfinite(r[k]) for r in rows for k in ("pe", "ke", "temp"))
