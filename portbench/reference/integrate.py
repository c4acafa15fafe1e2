"""The plain reference of the MD step (LAMMPS `real` units).

Velocity Verlet with the thermostats the cells run, written from LAMMPS'
definitions (`fix langevin`, `fix nvt` with a Nose-Hoover chain in the
Martyna-Tuckerman splitting); it imports nothing of the program under
test. A step:

  NVT: chain half step (velocities scaled)
  v += dt/2 ftm2v f / m ;  x += dt v
  f = F(x) (+ Langevin: -m / (damp ftm2v) v + sqrt(2 kB T m mvv2e /
      (dt damp)) xi, with v the half-kicked velocity)
  v += dt/2 ftm2v f / m
  NVT: chain half step
"""

from __future__ import annotations

import torch

BOLTZ = 0.0019872067  # kcal/mol/K
MVV2E = 48.88821291 * 48.88821291
FTM2V = 1.0 / MVV2E


def langevin_force(vel, masses, temp, damp, dt, noise):
    """The friction and random force of `fix langevin` (kcal/mol/A)."""
    gamma1 = -masses / (damp * FTM2V)
    sigma = torch.sqrt(2.0 * BOLTZ * temp * masses * MVV2E / (dt * damp))
    return gamma1[:, None] * vel + sigma[:, None] * noise


def nh_half_step(eta, eta_dot, vel, masses, dof, dt, temp, tdamp):
    """A Nose-Hoover chain (length len(eta_dot), one loop) over dt/2:
    tail to head, the velocity scale, head to tail. Returns (eta,
    eta_dot, vel)."""
    kt = BOLTZ * temp
    chain = len(eta_dot)
    q = [dof * kt * tdamp ** 2] + [kt * tdamp ** 2] * (chain - 1)
    ed = list(eta_dot.unbind(0))
    ke2 = MVV2E * torch.sum(masses * (vel * vel).sum(-1))
    dts = dt / 2.0

    def g(k, ke2):
        if k == 0:
            return (ke2 - dof * kt) / q[0]
        return (q[k - 1] * (ed[k - 1] * ed[k - 1]) - kt) / q[k]

    def sweep(order, ke2):
        for k in order:
            gk = g(k, ke2)
            if k == chain - 1:
                ed[k] = ed[k] + 0.25 * dts * gk
            else:
                f = torch.exp(-0.125 * dts * ed[k + 1])
                ed[k] = (ed[k] * f + 0.25 * dts * gk) * f

    # tail -> head, every force from the chain as it was
    gs = [g(k, ke2) for k in range(chain)]
    for k in range(chain - 1, -1, -1):
        if k == chain - 1:
            ed[k] = ed[k] + 0.25 * dts * gs[k]
        else:
            f = torch.exp(-0.125 * dts * ed[k + 1])
            ed[k] = (ed[k] * f + 0.25 * dts * gs[k]) * f
    s = torch.exp(-0.5 * dts * ed[0])
    ke2 = ke2 * s * s
    eta = eta + 0.5 * dts * torch.stack(ed)
    sweep(range(chain), ke2)
    return eta, torch.stack(ed), vel * s


def wrap(pos, origin, lengths):
    """Positions into the primary cell: origin + (f - floor(f)) L with
    f = (x - origin) / L, in the positions' dtype."""
    frac = (pos - origin) / lengths
    return origin + (frac - torch.floor(frac)) * lengths


def follow(md: dict, forces, masses, pos, vel, force, steps, noises=None,
           chain=None):
    """`steps` steps of the cell's integrator (`md`: the traffic file's
    "md" group) from (pos, vel, force), every operation in their dtype,
    with `forces(pos) -> [n, 3]` the potential's forces in that dtype;
    `noises(k)`: the Langevin normals of step k; `chain`: (eta, eta_dot)
    of a Nose-Hoover chain. Returns (pos, vel, force, chain, the last
    step's Langevin force or None)."""
    dt = float(md["dt"])
    n = pos.shape[0]
    dof = 3 * n - 3
    kind = md["integrator"]
    f_lang = None
    for k in range(steps):
        if kind == "nose_hoover":
            eta, ed, vel = nh_half_step(*chain, vel, masses, dof, dt,
                                        md["temp"], md["tdamp"])
            chain = (eta, ed)
        vel = vel + (0.5 * dt * FTM2V) * force / masses[:, None]
        pos = pos + dt * vel
        force = forces(pos)
        if kind == "langevin":
            f_lang = langevin_force(vel, masses, md["temp"], md["damp"], dt,
                                    noises(k))
            force = force + f_lang
        vel = vel + (0.5 * dt * FTM2V) * force / masses[:, None]
        if kind == "nose_hoover":
            eta, ed, vel = nh_half_step(*chain, vel, masses, dof, dt,
                                        md["temp"], md["tdamp"])
            chain = (eta, ed)
    return pos, vel, force, chain, f_lang


def temperature(vel, masses):
    n = vel.shape[0]
    ke = 0.5 * MVV2E * torch.sum(masses * (vel * vel).sum(-1))
    return float(2.0 * ke / ((3 * n - 3) * BOLTZ))

