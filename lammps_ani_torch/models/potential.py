"""The ANI potential: AEV + per-species MLP ensemble + energy shifter
(+ XTB repulsion).

Port of lammps_ani_tpu/models/potential.py, three paths:

  * mirror (`atomic_energies_mirror`): the AEV over the neighbor matrix
    and its mirror tables (ops/nbr_grad.py), plain PyTorch, the JAX
    package's default engine; with `cellroll` its radial channel comes
    from the roll grid instead (the `xla` and `pallas` hybrids);
    `atomic_energies` is the same over a plain neighbor matrix;
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
import torch.utils.checkpoint
from torch import nn

from ..ops import aev_asn, aev_roll
from ..ops import cell_roll as crmod
from ..ops import nbr_grad
from ..ops import neighbors as nbops
from ..ops.neighbors import Box
from ..utils.profiling import phase
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
    # generic angular path: compacted neighbors per atom
    angular_capacity: int = 32
    # per-species angular-neighbor capacities (composition-derived by the
    # engine; required by the roll angular kernels; the species-blocked
    # AEV path of the mirror engine)
    angular_caps: Optional[tuple[int, ...]] = None
    atom_chunk: Optional[int] = None  # angular block in row chunks

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

    def select_models(self, num_models: Optional[int]) -> "ANIPotential":
        """A new potential of the first `num_models` ensemble members
        (None: all), on the same device and in the same dtype."""
        return ANIPotential(self.spec,
                            netmod.select_models(self.params, num_models))

    def with_spec(self, spec: ANISpec) -> "ANIPotential":
        """The same weights under another spec (e.g. new angular caps)."""
        return ANIPotential(spec, self.params)


def _energies_from_neighbors(pot, species, diff, dist, species_j, nbr_mask,
                             ghost_j, species_counts, local_mask,
                             angular_inputs=None, radial_override=None):
    """(diff, dist, species_j) -> [n] per-atom energies [Hartree]. The AEV
    is recomputed in the backward (torch.utils.checkpoint, as the JAX
    package's jax.checkpoint) instead of holding its [n, k, basis]
    intermediates. `angular_inputs`: a separate angular sub-list (the
    mirror path; `diff` may then be None)."""
    spec = pot.spec

    def aev_fn(d, dst, ang, rad):
        return aevmod.compute_aev(
            spec.aev, species, d, dst, species_j, nbr_mask,
            angular_capacity=spec.angular_capacity,
            angular_caps=spec.angular_caps, atom_chunk=spec.atom_chunk,
            angular_inputs=ang, radial_override=rad)

    args = (diff, dist, angular_inputs, radial_override)
    aev = (torch.utils.checkpoint.checkpoint(aev_fn, *args,
                                             use_reentrant=False)
           if torch.is_grad_enabled() else aev_fn(*args))
    with phase("nn_forward"):
        if species_counts is not None:
            atomic = netmod.atomic_energies_sorted(spec.net, pot.params,
                                                   species_counts, aev)
        else:
            atomic = netmod.atomic_energies_masked(spec.net, pot.params,
                                                   species, aev)
        e = netmod.ensemble_energies(atomic)
    e = e + spec.shifter(species, dtype=aev.dtype)
    if spec.repulsion is not None:
        e = e + repmod.repulsion_energies(
            spec.repulsion, species, species_j, dist, nbr_mask,
            ghost_center=~local_mask, ghost_j=ghost_j)
    return torch.where(local_mask, e, 0.0)


def atomic_energies_mirror(pot: ANIPotential, species: torch.Tensor,
                           pos: torch.Tensor, box: Box, nbrs,
                           species_counts: Optional[Sequence[int]] = None,
                           local_mask: Optional[torch.Tensor] = None,
                           cellroll=None) -> torch.Tensor:
    """[n] per-atom energies over `nbrs` (ops/nbr_grad.MirrorNeighbors):
    the radial channel and the repulsion term from the full list's
    distances, the angular channel from the sub-list's displacements,
    both with the mirror backward. `cellroll` = (RollGrid, RollBins,
    impl): the radial channel from the roll grid instead, "xla"
    (cell_roll.radial_aev_cellroll, plain PyTorch) or "pallas"
    (aev_roll.radial_aev_roll at shell 1, the radial kernels); it has no
    pair distances for the repulsion term."""
    if local_mask is None:
        local_mask = species >= 0
    radial_override = None
    dist = None
    species_j = nbrs.species_j
    nbr_mask = nbrs.mask
    ghost_j = torch.any(nbrs.shift != 0, dim=-1)
    if cellroll is not None:
        if pot.spec.repulsion is not None:
            raise ValueError("the cell-roll radial channel has no pair "
                             "distances for the repulsion term")
        grid, bins = cellroll[0], cellroll[1]
        impl = cellroll[2] if len(cellroll) > 2 else "xla"
        if impl == "pallas":
            radial_override = aev_roll.radial_aev_roll(
                pot.spec.aev, grid, bins, pos, box,
                species_counts=species_counts)
        else:
            radial_override = crmod.radial_aev_cellroll(pot.spec.aev, grid,
                                                        bins, pos, box)
        radial_override = torch.where(local_mask[:, None], radial_override,
                                      0.0)
    else:
        dist = nbr_grad.neighbor_dist(pos, box.h, nbrs.src,
                                      nbrs.shift.to(pos.dtype), nbrs.mirror,
                                      nbrs.mask)
        if species_j is None:
            species_j = torch.where(nbrs.mask, species[nbrs.src], -1)
        nbr_mask = nbrs.mask & (species_j >= 0)

    angular_inputs = None
    diff = None
    if nbrs.ang_src is not None:
        a_diff, a_dist = nbr_grad.neighbor_displacements_mirror(
            pos, box, nbrs.ang_src, nbrs.ang_shift, nbrs.ang_mirror,
            nbrs.ang_mask)
        a_species = (nbrs.ang_species if nbrs.ang_species is not None
                     else torch.where(nbrs.ang_mask, species[nbrs.ang_src],
                                      -1))
        angular_inputs = (a_diff, a_dist, a_species,
                          nbrs.ang_mask & (a_species >= 0))
    else:
        diff, dist = nbr_grad.neighbor_displacements_mirror(
            pos, box, nbrs.src, nbrs.shift, nbrs.mirror, nbrs.mask)
    return _energies_from_neighbors(
        pot, species, diff, dist, species_j, nbr_mask, ghost_j,
        species_counts, local_mask, angular_inputs=angular_inputs,
        radial_override=radial_override)


def atomic_energies(pot: ANIPotential, species: torch.Tensor,
                    pos: torch.Tensor, box: Box, nlist,
                    species_counts: Optional[Sequence[int]] = None,
                    local_mask: Optional[torch.Tensor] = None):
    """[n] per-atom energies [Hartree] over a plain neighbor matrix, ghosts
    the periodic images of `nlist`; differentiable w.r.t. `pos` (through
    the images, by plain autograd) and `box.h`."""
    if local_mask is None:
        local_mask = species >= 0
    pos_ext = nbops.extended_positions(pos, box, nlist.ghosts)
    species_ext = nbops.extended_species(species, nlist.ghosts)
    idx, mask = nlist.idx, nlist.mask
    diff = torch.where(mask[..., None], pos[:, None, :] - pos_ext[idx], 1.0)
    dist = torch.linalg.norm(torch.where(mask[..., None], diff, 1.0), dim=-1)
    dist = torch.where(mask, dist, 1e6)
    species_j = species_ext[idx]
    return _energies_from_neighbors(
        pot, species, diff, dist, species_j, mask & (species_j >= 0),
        idx >= pos.shape[0], species_counts, local_mask)


def potential_energy(pot, species, pos, box, nlist, species_counts=None,
                     local_mask=None) -> torch.Tensor:
    """Scalar total energy [Hartree]."""
    return atomic_energies(pot, species, pos, box, nlist, species_counts,
                           local_mask).sum()


def energy_forces(pot, species, pos, box, nlist, species_counts=None,
                  local_mask=None):
    """(E, F [n, 3]) [Hartree, Hartree/A]; the image terms reach their
    owners through autograd."""
    with torch.enable_grad():
        pos_ = pos.detach().requires_grad_(True)
        e = potential_energy(pot, species, pos_, box, nlist, species_counts,
                             local_mask)
        (dpos,) = torch.autograd.grad(e, (pos_,))
    return e.detach(), -dpos


def energy_forces_virial(pot, species, pos, box, nlist, species_counts=None,
                         local_mask=None):
    """(E, F, W): the virial W = -dE/d(strain) from the additive strain."""
    energy, deps, dpos, _ = _strained(
        pos, box, lambda p, b: (atomic_energies(
            pot, species, p, b, nlist, species_counts, local_mask), None))
    return energy, -dpos, -0.5 * (deps + deps.T)


def energy_forces_virial_mirror(pot, species, pos, box, nbrs,
                                species_counts=None, local_mask=None,
                                cellroll=None):
    """(E, F, W) over the mirror tables; the box cotangent of the custom
    backward (dE/dh = -sum shift^T g) carries the virial."""
    energy, deps, dpos, _ = _strained(
        pos, box, lambda p, b: (atomic_energies_mirror(
            pot, species, p, b, nbrs, species_counts, local_mask,
            cellroll=cellroll), None))
    return energy, -dpos, -0.5 * (deps + deps.T)


def atomic_energies_roll(pot: ANIPotential, species: torch.Tensor,
                         pos: torch.Tensor, box: Box, grid, bins,
                         species_counts: Optional[Sequence[int]],
                         radial_shell: int = 2):
    """([n] energies, angular-cap deficit) via the roll-grid AEV kernels.

    With `species_counts`, atoms are sorted by species, `species_counts[s]`
    of species s (the sorted MLP); None: any order (the masked MLP, every
    net on every atom). Needs spec.angular_caps. `deficit` > 0 means an
    angular cap truncated real neighbors this evaluation — treat it like a
    capacity overflow."""
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
    with phase("nn_forward"):
        if species_counts is not None:
            atomic = netmod.atomic_energies_sorted(spec.net, pot.params,
                                                   species_counts, aev)
        else:
            # the caps say which species occur as neighbors, not as
            # centers: every net runs
            atomic = netmod.atomic_energies_masked(spec.net, pot.params,
                                                   species, aev)
        e = netmod.ensemble_energies(atomic)
    e = e + spec.shifter(species, dtype=aev.dtype)
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
                              species_counts: Optional[Sequence[int]],
                              radial_shell: int = 2):
    """(E, F [n,3], W [3,3], deficit) in Hartree units; the kernels'
    backward supplies exact dpos and box cotangents."""
    energy, deps, dpos, deficit = _strained(
        pos, box, lambda p, b: atomic_energies_roll(
            pot, species, p, b, grid, bins, species_counts, radial_shell))
    return energy, -dpos, -0.5 * (deps + deps.T), deficit


def atomic_energies_asn(pot: ANIPotential, species: torch.Tensor,
                        pos: torch.Tensor, box: Box, asn_state,
                        species_counts: Optional[Sequence[int]],
                        plain: bool = False,
                        present_species: Optional[tuple] = None):
    """([n] energies, angular deficit) via the assignment path.

    `asn_state` = (grid, bins, asn, sections[, tiers[, pair_stage]]): one
    coarse roll grid (bin side >= Rcr + skin), its bins, the frozen
    assignment of `aev_asn.build_assignment` and its sections, optional
    occupancy tiers and the angular pair stage (`aev_asn.PAIR_STAGES`,
    default "packed"). With `species_counts`, atoms are sorted by species,
    `species_counts[s]` of species s (the sorted MLP); None: any order (the
    masked MLP over the nets of `present_species`, None: all). Both AEV
    channels come in compact columns (present radial sections, present
    species-pair blocks); the first MLP layer gathers the matching weight
    rows. With spec.repulsion, the XTB energies of the same kernel pass are
    added. `plain=True` runs the kernels' plain versions whatever the
    device."""
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
    col_idx = asn_col_idx(spec, sect)
    with phase("nn_forward"):
        if species_counts is not None:
            atomic = netmod.atomic_energies_sorted(spec.net, pot.params,
                                                   species_counts, aev,
                                                   col_idx=col_idx)
        else:
            atomic = netmod.atomic_energies_masked(
                spec.net, pot.params, species, aev, present=present_species,
                col_idx=col_idx)
        e = netmod.ensemble_energies(atomic)
    e = e + spec.shifter(species, dtype=aev.dtype)
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
                             species_counts: Optional[Sequence[int]]):
    """(E, F [n,3], W [3,3], deficit) in Hartree units via the asn path;
    the fused op's backward supplies exact dpos and box cotangents."""
    energy, deps, dpos, deficit = _strained(
        pos, box, lambda p, b: atomic_energies_asn(
            pot, species, p, b, asn_state, species_counts))
    return energy, -dpos, -0.5 * (deps + deps.T), deficit
