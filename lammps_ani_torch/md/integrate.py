"""Velocity-Verlet pieces and the Langevin thermostat (LAMMPS `real`
units).

Port of lammps_ani_tpu/md/integrate.py (`fix nve`, `fix langevin`,
`velocity create`). Random numbers come from an explicit
`torch.Generator`, or are passed in (the tests feed the JAX package's
noise to check the formula).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import units


def kinetic_energy(vel: torch.Tensor, masses: torch.Tensor) -> torch.Tensor:
    """[] kcal/mol."""
    return 0.5 * units.MVV2E * torch.sum(masses * torch.sum(vel * vel, -1))


def temperature(vel, masses, dof) -> torch.Tensor:
    """LAMMPS `compute temp`: T = 2 KE / (dof kB)."""
    return 2.0 * kinetic_energy(vel, masses) / (dof * units.BOLTZ)


def pressure_tensor(vel, masses, virial, volume) -> torch.Tensor:
    """[3,3] pressure in atm: (kinetic tensor + virial) / V * nktv2p."""
    kin = units.MVV2E * torch.einsum("i,ia,ib->ab", masses, vel, vel)
    return (kin + virial) / volume * units.NKTV2P


def create_velocities(generator: torch.Generator, masses: torch.Tensor,
                      temp: float, dof: Optional[int] = None,
                      zero_momentum: bool = True) -> torch.Tensor:
    """LAMMPS `velocity all create T seed`: gaussian, COM-zeroed, rescaled
    to exactly T. The normals are drawn on the generator's device."""
    n = masses.shape[0]
    if dof is None:
        dof = 3 * n - 3
    sigma = torch.sqrt(units.BOLTZ * temp / (masses * units.MVV2E))
    noise = torch.randn((n, 3), generator=generator, dtype=masses.dtype,
                        device=generator.device).to(masses.device)
    vel = noise * sigma[:, None]
    if zero_momentum:
        p = torch.sum(masses[:, None] * vel, dim=0)
        vel = vel - (p / torch.sum(masses))[None, :]
    t_now = temperature(vel, masses, dof)
    return vel * torch.sqrt(temp / torch.clamp(t_now, min=1e-30))


def nve_halfkick(vel, force, masses, dt):
    return vel + (0.5 * dt * units.FTM2V) * force / masses[:, None]


def nve_drift(pos, vel, dt):
    return pos + dt * vel


@dataclasses.dataclass
class Langevin:
    """LAMMPS `fix langevin T T damp seed`: friction plus a gaussian
    stochastic force, added to the NVE force."""

    temp: float
    damp: float  # fs
    generator: Optional[torch.Generator] = None

    def noise(self, shape, dtype, device) -> torch.Tensor:
        """Standard normals for one step (override to feed given noise)."""
        g = self.generator
        return torch.randn(shape, generator=g, dtype=dtype,
                           device=device if g is None else g.device
                           ).to(device)

    def force(self, vel, masses, dt, noise=None) -> torch.Tensor:
        """Extra force in kcal/mol/A: gamma1 v + sigma xi with
        sigma = sqrt(2 kB T m MVV2E / (dt damp))."""
        gamma1 = -masses / (self.damp * units.FTM2V)
        sigma = torch.sqrt(2.0 * units.BOLTZ * self.temp * masses
                           * units.MVV2E / (dt * self.damp))
        if noise is None:
            noise = self.noise(vel.shape, vel.dtype, vel.device)
        return gamma1[:, None] * vel + sigma[:, None] * noise
