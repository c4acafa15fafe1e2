"""FIRE energy minimization (LAMMPS `minimize` with `min_style fire`).

Port of lammps_ani_tpu/md/minimize.py: velocity Verlet plus a few scalar
controls, through the engine's own force path (on `pallas_asn` its
kernels), with the neighbor structure rebuilt every `rebuild_every`
steps. The controls stay tensors on the run's device; the host reads
max |F| once per chunk of `rebuild_every` steps, as the JAX package does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import units
from ..ops import neighbors as nbops


@dataclasses.dataclass(frozen=True)
class FireConfig:
    dt_start: float = 0.25  # fs
    dt_max: float = 1.0
    n_min: int = 5
    f_inc: float = 1.1
    f_dec: float = 0.5
    alpha_start: float = 0.1
    f_alpha: float = 0.99


def _rebuild(sim, state):
    """The state at its wrapped positions with a fresh neighbor structure
    (as `Simulation._chunk` rebuilds) and the structure `_forces` takes."""
    pos_w = nbops.wrap_positions(state.pos, state.box)
    bins = sim._bins(pos_w, state.box)
    nlist = nbrs = None
    struct = bins
    if sim._mirror_tables:
        nlist = sim._build_nlist(pos_w, state.box)
        nbrs = sim._mirror(nlist, pos_w, state.box)
        struct = (nbrs, bins)
    state = state.replace(pos=pos_w, pos_at_rebuild=pos_w, nlist=nlist,
                          nbrs=nbrs, bins=None if sim._asn else bins)
    return state, struct


def minimize(sim, state, max_steps: int = 1000, ftol: float = 1e-4,
             config: FireConfig = FireConfig()):
    """Relax `state` until max |F| < ftol (kcal/mol/A) or max_steps.

    Returns (state, {"steps", "fmax", "pe"}). Each FIRE step counts as a
    step of the state."""
    c = config
    chunk = sim.nbr.rebuild_every
    t = dict(dtype=state.pos.dtype, device=state.pos.device)
    dt = torch.tensor(c.dt_start, **t)
    alpha = torch.tensor(c.alpha_start, **t)
    n_pos = torch.zeros((), dtype=torch.int64, device=t["device"])
    masses = sim.masses[:, None]
    state = state.replace(vel=torch.zeros_like(state.vel))
    steps = 0
    fmax = np.inf
    while steps < max_steps:
        state, struct = _rebuild(sim, state)
        st = state
        for _ in range(chunk):
            vel = st.vel + (0.5 * dt * units.FTM2V) * st.force / masses
            pos = st.pos + dt * vel
            pe, force, virial, _ = sim._forces(pos, st.box, struct)
            vel = vel + (0.5 * dt * units.FTM2V) * force / masses
            p = torch.sum(force * vel)
            fnorm = torch.sqrt(torch.sum(force * force))
            vnorm = torch.sqrt(torch.sum(vel * vel))
            vel_mix = (1.0 - alpha) * vel + alpha * vnorm * force \
                / torch.clamp(fnorm, min=1e-30)
            uphill = p <= 0.0
            vel = torch.where(uphill, 0.0, vel_mix)
            n_pos = torch.where(uphill, 0, n_pos + 1)
            grow = ~uphill & (n_pos > c.n_min)
            dt = torch.where(grow, torch.clamp(dt * c.f_inc, max=c.dt_max),
                             torch.where(uphill, dt * c.f_dec, dt))
            alpha = torch.where(grow, alpha * c.f_alpha,
                                torch.where(uphill, c.alpha_start, alpha))
            st = st.replace(pos=pos, vel=vel, force=force, pe=pe,
                            virial=virial, step=st.step + 1)
        state = st
        steps += chunk
        fmax = float(torch.max(torch.abs(state.force)))
        if fmax < ftol:
            break
    return state, {"steps": steps, "fmax": fmax, "pe": float(state.pe)}
