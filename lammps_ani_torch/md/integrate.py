"""Integrators, thermostats and barostats (LAMMPS `real` units).

Port of lammps_ani_tpu/md/integrate.py: `fix nve`, `fix langevin`, `fix
nvt` (Nose-Hoover chains), `fix npt` (MTK isotropic piston), `fix
press/berendsen`, `fix recenter` and `velocity create`. Random numbers
come from an explicit `torch.Generator`, or are passed in (the tests feed
the JAX package's noise to check the formula).

The chains and the piston are a handful of scalars: tensor ops on the
run's device, with no read back to the host, in the JAX package's
update order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import units
from ..ops.neighbors import Box
from .state import BarostatState, ThermostatState


def kinetic_energy(vel: torch.Tensor, masses: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[] kcal/mol (over the atoms of `mask` where given)."""
    v2 = torch.sum(vel * vel, -1)
    if mask is not None:
        v2 = torch.where(mask, v2, 0.0)
    return 0.5 * units.MVV2E * torch.sum(masses * v2)


def temperature(vel, masses, dof, mask=None) -> torch.Tensor:
    """LAMMPS `compute temp`: T = 2 KE / (dof kB)."""
    return 2.0 * kinetic_energy(vel, masses, mask) / (dof * units.BOLTZ)


def pressure_tensor(vel, masses, virial, volume, mask=None) -> torch.Tensor:
    """[3,3] pressure in atm: (kinetic tensor + virial) / V * nktv2p."""
    if mask is not None:
        vel = torch.where(mask[:, None], vel, 0.0)
    kin = units.MVV2E * torch.einsum("i,ia,ib->ab", masses, vel, vel)
    return (kin + virial) / volume * units.NKTV2P


def create_velocities(generator: torch.Generator, masses: torch.Tensor,
                      temp: float, dof: Optional[int] = None,
                      zero_momentum: bool = True,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LAMMPS `velocity all create T seed`: gaussian, COM-zeroed, rescaled
    to exactly T; with `mask`, over those atoms only (zeros elsewhere). The
    normals are drawn on the generator's device."""
    n = masses.shape[0]
    if dof is None:
        dof = 3 * n - 3
    sigma = torch.sqrt(units.BOLTZ * temp / (masses * units.MVV2E))
    noise = torch.randn((n, 3), generator=generator, dtype=masses.dtype,
                        device=generator.device).to(masses.device)
    vel = noise * sigma[:, None]
    if mask is not None:
        vel = torch.where(mask[:, None], vel, 0.0)
    if zero_momentum:
        mtot = (torch.sum(masses) if mask is None
                else torch.sum(torch.where(mask, masses, 0.0)))
        p = torch.sum(masses[:, None] * vel, dim=0)
        vel = vel - (p / mtot)[None, :]
        if mask is not None:
            vel = torch.where(mask[:, None], vel, 0.0)
    t_now = temperature(vel, masses, dof, mask)
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


def _chain_state(chain, dtype, device) -> ThermostatState:
    return ThermostatState(
        eta=torch.zeros((chain,), dtype=dtype, device=device),
        eta_dot=torch.zeros((chain,), dtype=dtype, device=device))


@dataclasses.dataclass(frozen=True)
class NoseHoover:
    """Nose-Hoover chain thermostat (LAMMPS `fix nvt temp T T tdamp`)."""

    temp: float
    tdamp: float  # fs
    chain: int = 3
    loops: int = 1

    def init(self, dtype=torch.float32, device=None) -> ThermostatState:
        return _chain_state(self.chain, dtype, device)

    def masses_q(self, dof):
        """Chain masses Q_k (energy * time^2 units)."""
        kt = units.BOLTZ * self.temp
        return dof * kt * self.tdamp ** 2, kt * self.tdamp ** 2

    def half_step(self, ts: ThermostatState, vel, masses, dof, dt,
                  ke2=None):
        """Advance the chain by dt/2 and scale the velocities
        (Martyna-Tuckerman), in the JAX package's order: tail to head,
        the velocity scale, head to tail. `ke2`: twice the kinetic energy
        (computed from `vel` where not given)."""
        kt = units.BOLTZ * self.temp
        q1, qk = self.masses_q(dof)
        q = [q1] + [qk] * (self.chain - 1)
        eta = ts.eta
        eta_dot = list(ts.eta_dot.unbind(0))
        if ke2 is None:
            ke2 = 2.0 * kinetic_energy(vel, masses)
        scale = None
        dts = dt / (2.0 * self.loops)
        last = self.chain - 1

        def g_of(k):
            # the force on chain element k >= 1 from element k - 1
            return (q[k - 1] * (eta_dot[k - 1] * eta_dot[k - 1]) - kt) / q[k]

        for _ in range(self.loops):
            # tail -> head, every force from the chain as it was
            g = [(ke2 - dof * kt) / q[0]] + [g_of(k)
                                             for k in range(1, self.chain)]
            for k in range(last, -1, -1):
                if k == last:
                    eta_dot[k] = eta_dot[k] + 0.25 * dts * g[k]
                else:
                    f = torch.exp(-0.125 * dts * eta_dot[k + 1])
                    eta_dot[k] = (eta_dot[k] * f + 0.25 * dts * g[k]) * f
            s = torch.exp(-0.5 * dts * eta_dot[0])
            scale = s if scale is None else scale * s
            ke2 = ke2 * s * s
            eta = eta + 0.5 * dts * torch.stack(eta_dot)
            # head -> tail with the scaled kinetic energy
            g0 = (ke2 - dof * kt) / q[0]
            for k in range(self.chain):
                gk = g0 if k == 0 else g_of(k)
                if k == last:
                    eta_dot[k] = eta_dot[k] + 0.25 * dts * gk
                else:
                    f = torch.exp(-0.125 * dts * eta_dot[k + 1])
                    eta_dot[k] = (eta_dot[k] * f + 0.25 * dts * gk) * f
        return (ThermostatState(eta=eta, eta_dot=torch.stack(eta_dot)),
                vel * scale)


@dataclasses.dataclass(frozen=True)
class BerendsenBarostat:
    """LAMMPS `fix press/berendsen iso P P pdamp`: weak-coupling volume
    rescale toward the target pressure (not a strict NPT ensemble)."""

    press: float  # atm
    pdamp: float  # fs
    bulk_modulus: float = 2.2e4  # atm, water-like (LAMMPS `modulus`)

    def scale_factor(self, p_now, dt):
        """Isotropic box and position scale for one step; the volume
        factor clipped to [0.9, 1.1] as LAMMPS does."""
        mu3 = 1.0 - dt / self.pdamp * (self.press - p_now) / self.bulk_modulus
        return torch.clamp(mu3, 0.9, 1.1) ** (1.0 / 3.0)


@dataclasses.dataclass(frozen=True)
class NoseHooverNPT:
    """MTK-style isotropic NPT (LAMMPS `fix npt temp T T tdamp iso P P
    pdamp`): a Nose-Hoover chain on the particles and a Nose-Hoover piston
    on ln V with the MTK velocity correction. The piston velocity `omega`
    [1/fs] advances by half steps driven by (P - P0) 3V / W and the MTK
    kinetic term; positions and cell scale by exp(dt omega); velocities
    take exp(-dt/2 (1 + 3/dof) omega) around their half kicks."""

    temp: float
    tdamp: float  # fs
    press: float  # atm
    pdamp: float  # fs
    chain: int = 3

    @property
    def thermostat(self) -> NoseHoover:
        return NoseHoover(temp=self.temp, tdamp=self.tdamp, chain=self.chain)

    def init(self, dtype=torch.float32, device=None) -> BarostatState:
        return BarostatState(
            omega=torch.zeros((), dtype=dtype, device=device),
            omega_chain=_chain_state(self.chain, dtype, device))

    def piston_mass(self, n_atoms: int) -> float:
        """W = (dof + 3) kT pdamp^2, energy * time^2 units."""
        return (3.0 * n_atoms + 3.0) * units.BOLTZ * self.temp \
            * self.pdamp ** 2

    def piston_half(self, bs: BarostatState, p_now, volume, ke, n_atoms, dt,
                    dof=None) -> BarostatState:
        """Advance omega by dt/2 (p_now in atm, volume in A^3, ke in
        kcal/mol). The MTK kinetic term takes N_f = `dof` (3 N - 3 where not
        given), as `vel_scale`'s 1 + 3/dof does."""
        if dof is None:
            dof = 3.0 * n_atoms - 3.0
        w = self.piston_mass(n_atoms)
        g = (3.0 * volume * (p_now - self.press) * units.ATM2ENGVOL
             + (3.0 / dof) * 2.0 * ke) / w
        # the piston's own Nose-Hoover thermostat, for ergodicity
        kt = units.BOLTZ * self.temp
        q = kt * self.pdamp ** 2
        eta, eta_dot = bs.omega_chain.eta, bs.omega_chain.eta_dot
        g_eta = (w * (bs.omega * bs.omega) - kt) / q
        ed0 = eta_dot[0] + 0.25 * dt * g_eta
        omega = bs.omega * torch.exp(-0.5 * dt * ed0) + 0.5 * dt * g
        eta0 = eta[0] + 0.5 * dt * ed0
        return BarostatState(
            omega=omega,
            omega_chain=ThermostatState(
                eta=torch.cat([eta0[None], eta[1:]]),
                eta_dot=torch.cat([ed0[None], eta_dot[1:]])))

    def vel_scale(self, omega, dof, n_atoms, dt):
        """The velocity factor over dt/2 (the MTK correction)."""
        alpha = 1.0 + 3.0 / dof
        return torch.exp(-0.5 * dt * alpha * omega)

    def box_scale(self, omega, dt):
        return torch.exp(dt * omega)


def rescale_box(box: Box, scale) -> Box:
    """Isotropic cell rescale about the box origin."""
    return Box(h=box.h * scale, origin=box.origin)


def recenter(pos, masses, target_com):
    """LAMMPS `fix recenter`: shift so the COM sits at `target_com`."""
    com = torch.sum(masses[:, None] * pos, dim=0) / torch.sum(masses)
    return pos + (target_com - com)[None, :]


def zero_momentum(vel, masses, mask=None):
    """Velocities less the center-of-mass velocity (of the atoms of `mask`
    where given; zeros elsewhere)."""
    m = masses if mask is None else torch.where(mask, masses, 0.0)
    p = torch.sum(m[:, None] * vel, dim=0)
    v = vel - (p / torch.sum(m))[None, :]
    return v if mask is None else torch.where(mask[:, None], v, 0.0)
