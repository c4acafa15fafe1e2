"""What decides `correct`: the window's own outputs against the reference.

Of the window's newest chunk that regrew nothing (`md.Chunk`), the
reference (portbench/reference/, f64 on the card)

  * evaluates the potential at the positions the chunk ended at; the
    program's forces there (a Langevin cell's: the state's less the
    chunk's last Langevin force, rebuilt from the state's velocity and the
    replayed noise) and virial are compared with it;
  * follows the chunk's steps from the program's state at its start (its
    positions wrapped as the rebuild wraps them, velocities, forces and
    thermostat chain, the Langevin noise replayed from the generator's
    state before the chunk) with its own forces, holding and stepping the
    state in the configuration's dtype in the program's order of
    operations, so that only the forces tell the two apart; the program's
    positions and velocities at the end are compared with it.

`numbers` computes every number the check can compare; a cell's limits
file (`portbench/limits/<cell>.json`) names those it compares, each with
the program's and the control's readings it was set from. The control is
the same reference in f32 with TF32 products (the precision below the
configuration's f32 with TF32 off) put in the program's place
(`python -m portbench.control`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from .reference import ani
from .reference import integrate as ref_md

NUMBERS = ("energy", "force_max", "force_q90", "force_rms", "virial",
           "position_max", "position_rms", "velocity_max", "velocity_q90",
           "velocity_rms")


@dataclasses.dataclass
class Outputs:
    """A chunk's outputs: the potential at the end positions, and the
    state at the end."""

    pe: torch.Tensor  # [] kcal/mol
    force: torch.Tensor  # [n, 3] kcal/mol/A, the potential's alone
    virial: torch.Tensor  # [3, 3] kcal/mol
    pos: torch.Tensor  # [n, 3] A
    vel: torch.Tensor  # [n, 3] A/fs


@dataclasses.dataclass
class Case:
    """One chunk of the program's window, in the program's atom order."""

    md: dict  # the traffic file's "md" group
    species: torch.Tensor  # [n] int64
    masses: torch.Tensor  # [n] float64
    lengths: torch.Tensor  # [3] float64
    origin: torch.Tensor  # [3] float64
    start: dict  # pos, vel, force [n, 3], chain (eta, eta_dot) or None
    end: dict  # pos, vel, force, pe, virial
    steps: int
    gen_state: object  # the noise generator's state before the chunk


def case_of(run, traffic, system, chunk) -> Case:
    """The program's chunk as the reference reads it: its states in the
    program's atom order (the benchmark's species and masses permuted by
    `sim.order` to match)."""
    sim, b, a = run.sim, chunk.before, chunk.after
    order = torch.as_tensor(sim.order)
    dev = b.pos.device

    def f64(t):
        return t.detach().to(torch.float64).clone()

    chain = None
    if b.thermostat is not None:
        chain = (f64(b.thermostat.eta), f64(b.thermostat.eta_dot))
    return Case(
        md=traffic["md"],
        species=torch.as_tensor(system.species)[order].to(dev),
        masses=torch.as_tensor(system.masses)[order].to(dev),
        lengths=torch.as_tensor(system.lengths, dtype=torch.float64).to(dev),
        origin=torch.as_tensor(system.origin, dtype=torch.float64).to(dev),
        start={"pos": f64(b.pos), "vel": f64(b.vel), "force": f64(b.force),
               "chain": chain},
        end={"pos": f64(a.pos), "vel": f64(a.vel), "force": f64(a.force),
             "pe": f64(a.pe), "virial": f64(a.virial)},
        steps=a.step - b.step, gen_state=chunk.gen_state)


class Noise:
    """The Langevin normals of the chunk's steps, replayed in order from
    the generator's state before it, as the program draws them (one
    [n, 3] draw a step in the state's dtype on the generator's device)."""

    def __init__(self, gen_state, n, device, dtype):
        self.gen = torch.Generator(device=device)
        self.gen.set_state(gen_state)
        self.n, self.dtype, self.drawn = n, dtype, []

    def __call__(self, k):
        while len(self.drawn) <= k:
            self.drawn.append(torch.randn(
                (self.n, 3), generator=self.gen, dtype=self.dtype,
                device=self.gen.device).to(torch.float64))
        return self.drawn[k]


@contextlib.contextmanager
def tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def reference_outputs(cfg, params, case: Case, noise, dtype=torch.float64,
                      allow_tf32=False) -> Outputs:
    """The reference's potential in `dtype` (TF32 products where
    `allow_tf32`) at the chunk's end positions; and the chunk followed
    from its start with that potential's forces, the state held and
    stepped in the configuration's dtype as the configuration states it
    (positions wrapped into the box at the chunk's rebuild, as LAMMPS
    remaps them), so that only the forces tell the two runs apart."""
    dev = case.start["pos"].device
    sd = getattr(torch, cfg["dtype"])
    model = ani.Model(cfg, params, dtype, dev)
    with tf32(allow_tf32):
        pe, force, virial = ani.energy_forces_virial(
            model, case.species, case.end["pos"].to(dtype),
            case.lengths.to(dtype))

        def forces(x):
            return ani.energy_forces_virial(
                model, case.species, x.to(dtype), case.lengths.to(dtype)
            )[1].to(sd)

        chain = case.start["chain"]
        if chain is not None:
            chain = tuple(c.to(sd) for c in chain)
        pos0 = ref_md.wrap(case.start["pos"].to(sd), case.origin.to(sd),
                           case.lengths.to(sd))
        pos, vel, *_ = ref_md.follow(
            case.md, forces, case.masses.to(sd), pos0,
            case.start["vel"].to(sd), case.start["force"].to(sd),
            case.steps, noises=None if noise is None
            else (lambda k: noise(k).to(sd)), chain=chain)
    return Outputs(pe=pe, force=force, virial=virial, pos=pos, vel=vel)


def program_outputs(case: Case, noise) -> Outputs:
    """The program's outputs of the chunk: a Langevin cell's state force
    less the last step's Langevin force (the half-kicked velocity rebuilt
    from the state as v - dt/2 ftm2v F / m)."""
    end, md = case.end, case.md
    force = end["force"]
    if md["integrator"] == "langevin":
        dt = float(md["dt"])
        m = case.masses[:, None]
        v_half = end["vel"] - (0.5 * dt * ref_md.FTM2V) * force / m
        force = force - ref_md.langevin_force(
            v_half, case.masses, md["temp"], md["damp"], dt,
            noise(case.steps - 1))
    return Outputs(pe=end["pe"], force=force, virial=end["virial"],
                   pos=end["pos"], vel=end["vel"])


def noise_of(case: Case, cfg: dict, device):
    """The chunk's Langevin noise, replayed (None for another
    integrator)."""
    if case.md["integrator"] != "langevin":
        return None
    return Noise(case.gen_state, len(case.species), device,
                 getattr(torch, cfg["dtype"]))


def readings(cfg, params, case: Case, device, control=False) -> tuple:
    """(the program's numbers, the control's numbers or None), each
    against the f64 reference."""
    noise = noise_of(case, cfg, device)
    ref = reference_outputs(cfg, params, case, noise)
    got = numbers(program_outputs(case, noise), ref, case.lengths,
                  case.start["vel"])
    if not control:
        return got, None
    ctl = reference_outputs(cfg, params, case, noise_of(case, cfg, device),
                            dtype=torch.float32, allow_tf32=True)
    return got, numbers(ctl, ref, case.lengths, case.start["vel"])


def numbers(got: Outputs, ref: Outputs, lengths, start_vel) -> dict:
    """Every number the check can compare (`NUMBERS`); a cell's limits
    file names those it compares."""
    f64 = torch.float64
    n = ref.pos.shape[0]

    def rms(x):
        return torch.sqrt((x * x).sum(-1).mean())

    fr = ref.force.to(f64)
    df = (got.force.to(f64) - fr).norm(dim=-1) / rms(fr)
    dx = ani.min_image(got.pos.to(f64) - ref.pos.to(f64),
                       lengths).norm(dim=-1)
    dv = (got.vel.to(f64) - ref.vel.to(f64)).norm(dim=-1) / rms(
        ref.vel.to(f64) - start_vel.to(f64))
    wr = ref.virial.to(f64)
    out = {
        "energy": (got.pe.to(f64) - ref.pe.to(f64)).abs() / n,
        "force_max": df.max(), "force_q90": quantile(df, 0.9),
        "force_rms": torch.sqrt((df * df).mean()),
        "virial": (got.virial.to(f64) - wr).abs().max() / wr.abs().max(),
        "position_max": dx.max(), "position_rms": torch.sqrt((dx * dx).mean()),
        "velocity_max": dv.max(), "velocity_q90": quantile(dv, 0.9),
        "velocity_rms": torch.sqrt((dv * dv).mean()),
    }
    return {k: float(v) for k, v in out.items()}


def quantile(x, q):
    """The q-quantile of a 1-D tensor (by sorting: torch.quantile takes
    at most 2^24 values)."""
    s, _ = torch.sort(x)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def verdict(values: dict, limits: dict) -> bool:
    """Every number that has a limit finite and within it."""
    return all(values[k] == values[k] and values[k] <= lim
               for k, lim in limits.items())
