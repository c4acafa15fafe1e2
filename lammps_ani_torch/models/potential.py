"""The ANI potential: AEV + per-species MLP ensemble + energy shifter.

Port of lammps_ani_tpu/models/potential.py, roll path only: both AEV
channels come from the roll-grid kernels of ops/aev_roll.py over one fine
bin grid (the JAX package's `pallas_full` engine). Forces come from
`torch.autograd.grad`, the virial from the derivative with respect to an
additive strain: pos -> pos + pos @ eps, h -> h + h @ eps at eps = 0,
W = -0.5 (dE/deps + dE/deps^T). Energies are in Hartree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops import aev_roll
from ..ops.neighbors import Box
from . import aev as aevmod
from . import networks as netmod


@dataclasses.dataclass(frozen=True)
class ANISpec:
    """Static potential configuration."""

    aev: aevmod.AEVSpec
    net: netmod.NetworkSpec
    shifter: netmod.EnergyShifter
    symbols: tuple[str, ...] = ("H", "C", "N", "O", "S", "F", "Cl")
    # per-species angular-neighbor capacities (composition-derived by the
    # engine; required by the roll angular kernels)
    angular_caps: Optional[tuple[int, ...]] = None

    @property
    def cutoff(self) -> float:
        return self.aev.radial_cutoff


class ANIPotential(nn.Module):
    """Potential = static spec + ensemble weights.

    The weights are buffers `s{species}_l{layer}_{w|b}` (w [m, in, out],
    b [m, out]), so `.to(device)` moves them; `params` gives them in the
    JAX package's nested layout (species -> layers -> {"w", "b"})."""

    def __init__(self, spec: ANISpec, params):
        super().__init__()
        self.spec = spec
        self._layers = [len(layers) for layers in params]
        for s, layers in enumerate(params):
            for li, layer in enumerate(layers):
                self.register_buffer(f"s{s}_l{li}_w", layer["w"])
                self.register_buffer(f"s{s}_l{li}_b", layer["b"])

    @property
    def params(self):
        return [[{"w": getattr(self, f"s{s}_l{li}_w"),
                  "b": getattr(self, f"s{s}_l{li}_b")}
                 for li in range(n)] for s, n in enumerate(self._layers)]

    @property
    def num_models(self) -> int:
        return self.s0_l0_w.shape[0]

    def with_spec(self, spec: ANISpec) -> "ANIPotential":
        """The same weights under another spec (e.g. new angular caps)."""
        return ANIPotential(spec, self.params)


def atomic_energies_roll(pot: ANIPotential, species: torch.Tensor,
                         pos: torch.Tensor, box: Box, grid, bins,
                         species_counts: Sequence[int],
                         radial_shell: int = 2):
    """([n] energies, angular-cap deficit) via the roll-grid AEV kernels.

    Atoms are sorted by species, `species_counts[s]` of species s. Needs
    spec.angular_caps. `deficit` > 0 means an angular cap truncated real
    neighbors this evaluation — treat it like a capacity overflow."""
    spec = pot.spec
    if spec.angular_caps is None:
        raise ValueError("the roll path needs composition-derived "
                         "angular_caps")
    radial = aev_roll.radial_aev_roll(spec.aev, grid, bins, pos, box,
                                      species_counts=species_counts,
                                      shell=radial_shell)
    angular, deficit = aev_roll.angular_aev_roll(
        spec.aev, grid, bins, pos, box, spec.angular_caps,
        species_counts=species_counts)
    local = species >= 0
    aev = torch.where(local[:, None], torch.cat([radial, angular], dim=1), 0.0)
    atomic = netmod.atomic_energies_sorted(spec.net, pot.params,
                                           species_counts, aev)
    e = netmod.ensemble_energies(atomic) + spec.shifter(species,
                                                        dtype=aev.dtype)
    return torch.where(local, e, 0.0), deficit


def energy_forces_virial_roll(pot: ANIPotential, species: torch.Tensor,
                              pos: torch.Tensor, box: Box, grid, bins,
                              species_counts: Sequence[int],
                              radial_shell: int = 2):
    """(E, F [n,3], W [3,3], deficit) in Hartree units; the kernels'
    backward supplies exact dpos and box cotangents."""
    with torch.enable_grad():
        eps = torch.zeros((3, 3), dtype=pos.dtype, device=pos.device,
                          requires_grad=True)
        pos_ = pos.detach().requires_grad_(True)
        h = box.h.detach()
        # additive form: exactly pos at eps = 0
        box_d = Box(h=h + h @ eps, origin=box.origin)
        e, deficit = atomic_energies_roll(pot, species, pos_ + pos_ @ eps,
                                          box_d, grid, bins, species_counts,
                                          radial_shell)
        energy = e.sum()
        deps, dpos = torch.autograd.grad(energy, (eps, pos_))
    virial = -0.5 * (deps + deps.T)
    return energy.detach(), -dpos, virial, deficit
