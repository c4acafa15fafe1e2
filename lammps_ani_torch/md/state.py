"""Simulation state.

Port of lammps_ani_tpu/md/state.py: everything that evolves during a run
(LAMMPS `real` units), held as tensors on the run's device, with the
Nose-Hoover chain and barostat states of the nvt and npt ensembles.

The JAX state also carries its PRNG key (`rng`). This port does not: the
Langevin thermostat draws from its own explicit `torch.Generator`
(md/integrate.py), so the noise stream lives with the integrator, not in
the state; a restart carries that generator's state (io/restart.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.neighbors import Box


@dataclasses.dataclass(frozen=True)
class ThermostatState:
    """Nose-Hoover chain state (also the barostat's piston chain)."""

    eta: torch.Tensor  # [chain] thermostat positions
    eta_dot: torch.Tensor  # [chain] thermostat velocities


@dataclasses.dataclass(frozen=True)
class BarostatState:
    omega: torch.Tensor  # [] piston velocity of ln V (iso), 1/fs
    omega_chain: ThermostatState


@dataclasses.dataclass(frozen=True)
class MDState:
    pos: torch.Tensor  # [n, 3] Angstrom
    vel: torch.Tensor  # [n, 3] Angstrom/fs
    force: torch.Tensor  # [n, 3] kcal/mol/Angstrom
    box: Box
    step: int
    pe: torch.Tensor  # [] kcal/mol at `pos`
    virial: torch.Tensor  # [3, 3] kcal/mol
    pos_at_rebuild: torch.Tensor  # [n, 3] for the half-skin check
    bins: Optional[object] = None  # ops/cell_roll.RollBins of the rebuild
    # mirror engine and hybrids: the rebuild's neighbor matrix
    # (ops/neighbors.NeighborList) and its owner/shift/mirror form
    # (ops/nbr_grad.MirrorNeighbors)
    nlist: Optional[object] = None
    nbrs: Optional[object] = None
    # NoseHoover / NoseHooverNPT: the particles' chain; NoseHooverNPT: the
    # piston and its chain
    thermostat: Optional[ThermostatState] = None
    barostat: Optional[BarostatState] = None

    def replace(self, **kw) -> "MDState":
        return dataclasses.replace(self, **kw)
