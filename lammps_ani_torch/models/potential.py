"""The ANI potential: AEV + per-species MLP ensemble + energy shifter
(+ XTB repulsion).

Port of lammps_ani_tpu/models/potential.py, two paths:

  * roll (`atomic_energies_roll`): both AEV channels from the roll-grid
    kernels of ops/aev_roll.py over one fine bin grid (the JAX package's
    `pallas_full` engine); no repulsion term;
  * asn (`atomic_energies_asn`): both channels and the repulsion energy
    from the assignment-compacted kernels of ops/aev_asn.py over one
    coarse grid (the `pallas_asn` engine), in compact AEV columns.

Forces come from
`torch.autograd.grad`, the virial from the derivative with respect to an
additive strain: pos -> pos + pos @ eps, h -> h + h @ eps at eps = 0,
W = -0.5 (dE/deps + dE/deps^T). Energies are in Hartree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops import aev_asn, aev_roll
from ..ops.neighbors import Box
from . import aev as aevmod
from . import networks as netmod
from . import repulsion as repmod


@dataclasses.dataclass(frozen=True)
class ANISpec:
    """Static potential configuration."""

    aev: aevmod.AEVSpec
    net: netmod.NetworkSpec
    shifter: netmod.EnergyShifter
    repulsion: Optional[repmod.RepulsionSpec] = None
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
    if spec.repulsion is not None:
        raise ValueError("the roll path has no pair-distance channel for "
                         "the repulsion term; use the asn path")
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


def _strained(pos, box, energy_fn):
    """(E, dE/deps, dE/dpos, aux) of energy_fn(pos + pos @ eps, box with
    h + h @ eps) at eps = 0 (the additive strain: exactly pos at eps = 0);
    energy_fn returns (per-atom energies, aux)."""
    with torch.enable_grad():
        eps = torch.zeros((3, 3), dtype=pos.dtype, device=pos.device,
                          requires_grad=True)
        pos_ = pos.detach().requires_grad_(True)
        h = box.h.detach()
        e, aux = energy_fn(pos_ + pos_ @ eps,
                           Box(h=h + h @ eps, origin=box.origin))
        energy = e.sum()
        deps, dpos = torch.autograd.grad(energy, (eps, pos_))
    return energy.detach(), deps, dpos, aux


def energy_forces_virial_roll(pot: ANIPotential, species: torch.Tensor,
                              pos: torch.Tensor, box: Box, grid, bins,
                              species_counts: Sequence[int],
                              radial_shell: int = 2):
    """(E, F [n,3], W [3,3], deficit) in Hartree units; the kernels'
    backward supplies exact dpos and box cotangents."""
    energy, deps, dpos, deficit = _strained(
        pos, box, lambda p, b: atomic_energies_roll(
            pot, species, p, b, grid, bins, species_counts, radial_shell))
    return energy, -dpos, -0.5 * (deps + deps.T), deficit


def atomic_energies_asn(pot: ANIPotential, species: torch.Tensor,
                        pos: torch.Tensor, box: Box, asn_state,
                        species_counts: Sequence[int], plain: bool = False):
    """([n] energies, angular deficit) via the assignment path.

    `asn_state` = (grid, bins, asn, sections[, tiers[, pair_stage]]): one
    coarse roll grid (bin side >= Rcr + skin), its bins, the frozen
    assignment of `aev_asn.build_assignment` and its sections, optional
    occupancy tiers and the angular pair stage (`aev_asn.PAIR_STAGES`,
    default "packed"). Atoms are sorted by species, `species_counts[s]`
    of species s. Both AEV channels come in compact columns (present radial
    sections, present species-pair blocks); the first MLP layer gathers
    the matching weight rows. With spec.repulsion, the XTB energies of
    the same kernel pass are added. `plain=True` runs the kernels' plain
    versions whatever the device."""
    spec = pot.spec
    if spec.angular_caps is None:
        raise ValueError("the asn path needs composition-derived "
                         "angular_caps")
    grid, bins, asn, sect = asn_state[:4]
    tiers = asn_state[4] if len(asn_state) > 4 else None
    pair_stage = asn_state[5] if len(asn_state) > 5 else "packed"
    radial, e_rep, angular, deficit = aev_asn.aev_asn_fused(
        spec.aev, grid, bins, asn, pos, box, sect, spec.angular_caps,
        tiers=tiers, repulsion=spec.repulsion, plain=plain,
        pair_stage=pair_stage)
    local = species >= 0
    aev = torch.where(local[:, None], torch.cat([radial, angular], dim=1),
                      0.0)
    atomic = netmod.atomic_energies_sorted(spec.net, pot.params,
                                           species_counts, aev,
                                           col_idx=asn_col_idx(spec, sect))
    e = netmod.ensemble_energies(atomic) + spec.shifter(species,
                                                        dtype=aev.dtype)
    if spec.repulsion is not None:
        e = e + e_rep
    return torch.where(local, e, 0.0), deficit


def asn_col_idx(spec: ANISpec, sections):
    """Columns of the full AEV that the asn path's compact AEV holds: the
    radial columns of the present sections, then the present species-pair
    blocks."""
    n_shf = len(spec.aev.shf_r) * len(spec.aev.eta_r)
    srl_full = spec.aev.num_species * n_shf
    asub = spec.aev.angular_sublength
    chans = aev_asn.present_channels(spec.aev, spec.angular_caps, sections)
    return tuple([s * n_shf + j for s, _ in sections for j in range(n_shf)]
                 + [srl_full + ch0 + j for ch0 in chans for j in range(asub)])


def energy_forces_virial_asn(pot: ANIPotential, species: torch.Tensor,
                             pos: torch.Tensor, box: Box, asn_state,
                             species_counts: Sequence[int]):
    """(E, F [n,3], W [3,3], deficit) in Hartree units via the asn path;
    the fused op's backward supplies exact dpos and box cotangents."""
    energy, deps, dpos, deficit = _strained(
        pos, box, lambda p, b: atomic_energies_asn(
            pot, species, p, b, asn_state, species_counts))
    return energy, -dpos, -0.5 * (deps + deps.T), deficit
