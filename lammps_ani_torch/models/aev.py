"""Atomic Environment Vector (AEV) symmetry functions — plain PyTorch.

Port of lammps_ani_tpu/models/aev.py. Definitions follow the published
ANI functional form (Smith et al., ANI-1, Chem. Sci. 2017; torchani):

  cutoff  : fc(r)  = 0.5 cos(pi r / Rc) + 0.5            (r <= Rc, else 0)
  radial  : G_R    = 0.25 exp(-eta_r (r - shf_r)^2) fc(r; Rcr)
  angular : G_A    = 2 ((1 + cos(theta - shf_z)) / 2)^zeta
                       exp(-eta_a ((r_ij + r_ik)/2 - shf_a)^2)
                       fc(r_ij; Rca) fc(r_ik; Rca),  theta = acos(0.95 cos)

Layout (torchani-compatible): radial block [species, eta_r * shf_r], then
angular block [pairs, eta_a * zeta * shf_a * shf_z], pairs enumerated
(0,0),(0,1),...,(S-1,S-1). `compute_aev` over a padded neighbor matrix is
the generic oracle the kernels of ops/aev_roll.py are held against; with
static per-species angular caps it takes the species-blocked path the
mirror engine runs.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AEVSpec:
    """Static AEV hyperparameters."""

    radial_cutoff: float
    angular_cutoff: float
    eta_r: tuple[float, ...]
    shf_r: tuple[float, ...]
    eta_a: tuple[float, ...]
    zeta: tuple[float, ...]
    shf_a: tuple[float, ...]
    shf_z: tuple[float, ...]
    num_species: int

    @property
    def num_pairs(self) -> int:
        s = self.num_species
        return s * (s + 1) // 2

    @property
    def radial_sublength(self) -> int:
        return len(self.eta_r) * len(self.shf_r)

    @property
    def angular_sublength(self) -> int:
        return (len(self.eta_a) * len(self.zeta) * len(self.shf_a)
                * len(self.shf_z))

    @property
    def radial_length(self) -> int:
        return self.num_species * self.radial_sublength

    @property
    def angular_length(self) -> int:
        return self.num_pairs * self.angular_sublength

    @property
    def aev_length(self) -> int:
        return self.radial_length + self.angular_length

    def triu_index(self) -> np.ndarray:
        """[S, S] -> unordered-pair channel index, torchani order."""
        s = self.num_species
        table = np.zeros((s, s), dtype=np.int32)
        idx = 0
        for a in range(s):
            for b in range(a, s):
                table[a, b] = idx
                table[b, a] = idx
                idx += 1
        return table


def _linspace_shifts(start: float, stop: float, n: int) -> tuple[float, ...]:
    """n shifts evenly spaced in [start, stop), torchani convention."""
    step = (stop - start) / n
    return tuple(start + i * step for i in range(n))


def ani2x_aev_spec() -> AEVSpec:
    """Published ANI-2x AEV hyperparameters (H,C,N,O,S,F,Cl); length
    7*16 + 28*32 = 1008."""
    return AEVSpec(
        radial_cutoff=5.1, angular_cutoff=3.5, eta_r=(19.7,),
        shf_r=_linspace_shifts(0.8, 5.1, 16), eta_a=(12.5,), zeta=(14.1,),
        shf_a=_linspace_shifts(0.8, 3.5, 4),
        shf_z=tuple((2 * i + 1) * math.pi / 16 for i in range(8)),
        num_species=7)


def ani1x_aev_spec() -> AEVSpec:
    """Published ANI-1x AEV hyperparameters (H,C,N,O); length 384."""
    return AEVSpec(
        radial_cutoff=5.2, angular_cutoff=3.5, eta_r=(16.0,),
        shf_r=_linspace_shifts(0.9, 5.2, 16), eta_a=(8.0,), zeta=(32.0,),
        shf_a=_linspace_shifts(0.9, 3.5, 4),
        shf_z=tuple((2 * i + 1) * math.pi / 16 for i in range(8)),
        num_species=4)


def cutoff_cosine(distances: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Smooth cosine cutoff; 0 beyond `cutoff`."""
    return torch.where(distances <= cutoff,
                       0.5 * torch.cos(distances * (math.pi / cutoff)) + 0.5,
                       0.0)


def radial_terms(spec: AEVSpec, distances: torch.Tensor) -> torch.Tensor:
    """[..., n_radial_sub] radial basis values for distances [...]."""
    t = dict(dtype=distances.dtype, device=distances.device)
    eta_r = torch.as_tensor(spec.eta_r, **t).reshape(-1, 1)
    shf_r = torch.as_tensor(spec.shf_r, **t).reshape(1, -1)
    d = distances[..., None, None]
    fc = cutoff_cosine(distances, spec.radial_cutoff)[..., None, None]
    out = 0.25 * torch.exp(-eta_r * (d - shf_r) ** 2) * fc
    return out.reshape(*distances.shape, spec.radial_sublength)


def _zeta_pow(base: torch.Tensor, zeta: float) -> torch.Tensor:
    """base ** zeta; integer zeta by square-and-multiply (as the JAX code)."""
    zi = int(round(zeta))
    if abs(zeta - zi) > 1e-9 or not (1 <= zi <= 128):
        return torch.exp(zeta * torch.log(base))
    acc, sq, n = None, base, zi
    while n:
        if n & 1:
            acc = sq if acc is None else acc * sq
        n >>= 1
        if n:
            sq = sq * sq
    return acc


def _angular_factor1(spec: AEVSpec, cos_theta: torch.Tensor) -> torch.Tensor:
    """[..., n_zeta * n_shf_z]: ((1 + cos(theta - shf_z)) / 2)^zeta, with
    cos(theta) = 0.95 cos_theta, sin(theta) = sqrt(1 - cos(theta)^2)."""
    t = dict(dtype=cos_theta.dtype, device=cos_theta.device)
    zeta = torch.as_tensor(spec.zeta, **t).reshape(-1, 1)
    cz = torch.as_tensor(np.cos(spec.shf_z), **t).reshape(1, -1)
    sz = torch.as_tensor(np.sin(spec.shf_z), **t).reshape(1, -1)
    c = 0.95 * torch.clamp(cos_theta, -1.0, 1.0)
    s = torch.sqrt(1.0 - c * c)
    base = 0.5 * (1.0 + c[..., None, None] * cz + s[..., None, None] * sz)
    if len(spec.zeta) == 1:
        out = _zeta_pow(base, spec.zeta[0])
    else:
        out = base ** zeta
    return out.reshape(*cos_theta.shape, -1)


def _angular_factor2(spec: AEVSpec, r12: torch.Tensor,
                     r13: torch.Tensor) -> torch.Tensor:
    """[..., n_eta_a * n_shf_a]: exp(-eta ((r12 + r13)/2 - shf_a)^2) fc fc."""
    t = dict(dtype=r12.dtype, device=r12.device)
    eta_a = torch.as_tensor(spec.eta_a, **t).reshape(-1, 1)
    shf_a = torch.as_tensor(spec.shf_a, **t).reshape(1, -1)
    rmean = 0.5 * (r12 + r13)
    fc = (cutoff_cosine(r12, spec.angular_cutoff)
          * cutoff_cosine(r13, spec.angular_cutoff))
    out = torch.exp(-eta_a * (rmean[..., None, None] - shf_a) ** 2)
    return (out * fc[..., None, None]).reshape(*r12.shape, -1)


def _to_torchani_layout(spec: AEVSpec, blk: torch.Tensor) -> torch.Tensor:
    """[..., E*A, Z*S] products -> 2 x [..., angular_sublength] in the
    torchani channel order (eta_a, zeta, shf_a, shf_z)."""
    ne, nz = len(spec.eta_a), len(spec.zeta)
    na, ns = len(spec.shf_a), len(spec.shf_z)
    lead = blk.shape[:-2]
    blk = blk.reshape(*lead, ne, na, nz, ns).transpose(-3, -2)
    return 2.0 * blk.reshape(*lead, spec.angular_sublength)


def angular_terms(spec: AEVSpec, r12: torch.Tensor, r13: torch.Tensor,
                  cos_theta: torch.Tensor) -> torch.Tensor:
    """[..., n_angular_sub] angular basis values, torchani channel order
    (eta_a, zeta, shf_a, shf_z). cos(theta - shf) is expanded with
    cos(theta) = 0.95 cos_theta, sin(theta) = sqrt(1 - cos(theta)^2)."""
    f1 = _angular_factor1(spec, cos_theta)
    f2 = _angular_factor2(spec, r12, r13)
    return _to_torchani_layout(spec, f2[..., :, None] * f1[..., None, :])


def _triangle_indices(k: int):
    """(row, col) indices of the strict upper triangle of [k, k]."""
    iu = np.triu_indices(k, 1)
    return iu[0].astype(np.int64), iu[1].astype(np.int64)


def _compact_onehot(mask: torch.Tensor, capacity: int, dist: torch.Tensor,
                    diff: torch.Tensor, species_j: torch.Tensor | None = None):
    """Left-compact the masked slots of each row into `capacity` columns,
    in slot order; slots ranked past `capacity` are dropped. Returns
    (diff_c, dist_c, mask_c[, species_c]), empty columns zero. The JAX
    package moves the slots with a one-hot matrix product (a TPU sort is
    slow); here a cumsum rank and one scatter give the same table."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    keep = mask & (rank < capacity)
    rows = torch.arange(n, device=mask.device)[:, None].expand_as(mask)
    at = (rows[keep], rank[keep])
    mask_c = torch.zeros((n, capacity), dtype=torch.bool, device=mask.device)
    mask_c[at] = True
    dist_c = dist.new_zeros((n, capacity)).index_put(at, dist[keep])
    diff_c = diff.new_zeros((n, capacity, 3)).index_put(at, diff[keep])
    out = (diff_c, dist_c, mask_c)
    if species_j is not None:
        sp = species_j.to(torch.int64)
        out = out + (sp.new_zeros((n, capacity)).index_put(at, sp[keep]),)
    return out


def _safe_units(diff_c, dist_c, mask_c, big):
    """(unit vectors, safe distances) of compacted slots; invalid slots get
    zero unit vectors and a huge distance (fc -> 0)."""
    safe = torch.where(mask_c, dist_c, 1.0)
    unit = torch.where(mask_c[..., None], diff_c / safe[..., None], 0.0)
    return unit, torch.where(mask_c, dist_c, big)


def _angular_generic(spec: AEVSpec, args):
    """[c, angular_length] via species-pair one-hot channels over the
    triangle of compacted slots: any species mix, one code path."""
    diff_c, dist_c, mask_c, spec_c = args
    c, ka = dist_c.shape
    unit, safe = _safe_units(diff_c, dist_c, mask_c,
                             2.0 * spec.angular_cutoff + 10.0)
    tri_k, tri_l = (torch.as_tensor(x, device=dist_c.device)
                    for x in _triangle_indices(ka))
    cos_kl = torch.sum(unit[:, tri_k] * unit[:, tri_l], dim=-1)
    aterms = angular_terms(spec, safe[:, tri_k], safe[:, tri_l], cos_kl)
    triu = torch.as_tensor(spec.triu_index(), dtype=torch.int64,
                           device=dist_c.device)
    pair_idx = triu[spec_c[:, tri_k], spec_c[:, tri_l]]
    onehot_p = torch.nn.functional.one_hot(pair_idx, spec.num_pairs).to(
        dist_c.dtype)
    out = torch.einsum("cqp,cqa->cpa", onehot_p, aterms)
    return out.reshape(c, spec.angular_length)


def _angular_blocked(spec: AEVSpec, caps: tuple[int, ...], per_species):
    """[c, angular_length] via static per-species neighbor blocks: each
    unordered species-pair channel is a sum over its block's slot pairs
    (triangle for a == b, the full product for a != b); absent species'
    blocks are zero. per_species: {species: (diff_c, dist_c, mask_c)}."""
    first = next(iter(per_species.values()))[1]
    c = first.shape[0]
    big = 2.0 * spec.angular_cutoff + 10.0
    nxy = spec.angular_sublength
    units, safes = {}, {}
    for s, (diff_c, dist_c, mask_c) in per_species.items():
        units[s], safes[s] = _safe_units(diff_c, dist_c, mask_c, big)
    blocks = []
    for a in range(spec.num_species):
        for b in range(a, spec.num_species):
            if a not in per_species or b not in per_species:
                blocks.append(first.new_zeros((c, nxy)))
                continue
            if a == b:
                tri_k, tri_l = (torch.as_tensor(x, device=first.device)
                                for x in _triangle_indices(caps[a]))
                u_k, u_l = units[a][:, tri_k], units[a][:, tri_l]
                r_k, r_l = safes[a][:, tri_k], safes[a][:, tri_l]
            else:
                ca, cb = caps[a], caps[b]
                u_k = torch.repeat_interleave(units[a], cb, dim=1)
                u_l = units[b].repeat(1, ca, 1)
                r_k = torch.repeat_interleave(safes[a], cb, dim=1)
                r_l = safes[b].repeat(1, ca)
            cos_kl = torch.sum(u_k * u_l, dim=-1)
            f1 = _angular_factor1(spec, cos_kl)  # [c, q, Z*S]
            f2 = _angular_factor2(spec, r_k, r_l)  # [c, q, E*A]
            blk = torch.einsum("cqx,cqy->cxy", f2, f1)
            blocks.append(_to_torchani_layout(spec, blk))
    return torch.cat(blocks, dim=1)


def angular_cap_deficit(spec: AEVSpec, dist: torch.Tensor,
                        species_j: torch.Tensor, nbr_mask: torch.Tensor,
                        caps: tuple[int, ...]) -> torch.Tensor:
    """[] max over atoms and species of (per-species angular degree - cap);
    > 0 means `caps` truncates neighbors (treat it as an overflow)."""
    in_ang = nbr_mask & (dist < spec.angular_cutoff)
    worst = torch.full((), -(2 ** 30), dtype=torch.int64, device=dist.device)
    for s, cap in enumerate(caps):
        count = torch.sum(in_ang & (species_j == s), dim=1)
        worst = torch.maximum(worst, count.max() - cap)
    return worst


def compute_aev(spec: AEVSpec, species_center: torch.Tensor,
                diff: torch.Tensor, dist: torch.Tensor,
                species_j: torch.Tensor, nbr_mask: torch.Tensor, *,
                angular_capacity: int = 32,
                angular_caps: tuple[int, ...] | None = None,
                atom_chunk: int | None = None, angular_inputs=None,
                radial_override: torch.Tensor | None = None) -> torch.Tensor:
    """[n, aev_length] over a padded full neighbor matrix.
    diff[i, k] = pos_i - pos_j; invalid slots masked. Differentiable
    w.r.t. `diff` and `dist`.

    `angular_caps`: static per-species angular capacities (0 for absent
    species): the species-blocked angular path instead of the generic
    one-hot one (the default). `atom_chunk`: the angular block in row
    chunks of this many atoms. `angular_inputs` (diff_a, dist_a,
    species_a, mask_a) [n, ka]: a separate angular neighbor sub-list.
    `radial_override` [n, radial_length]: a radial block computed
    elsewhere (`diff`, `dist` may then be None)."""
    big = 2.0 * spec.radial_cutoff + 10.0
    if radial_override is not None:
        n = radial_override.shape[0]
        radial = radial_override
    else:
        n, _ = dist.shape
        dist = torch.where(nbr_mask, dist, big)
        species_j = torch.where(nbr_mask, species_j, 0).to(torch.int64)
        rterms = radial_terms(spec, dist)
        rterms = torch.where(nbr_mask[..., None], rterms, 0.0)
        onehot = torch.nn.functional.one_hot(species_j, spec.num_species).to(
            dist.dtype) * nbr_mask[..., None]
        radial = torch.einsum("nks,nkr->nsr", onehot, rterms).reshape(
            n, spec.radial_length)

    if angular_inputs is not None:
        a_diff, a_dist, a_species, a_mask = angular_inputs
        a_dist = torch.where(a_mask, a_dist, big)
        a_species = torch.where(a_mask, a_species, 0).to(torch.int64)
    else:
        a_diff, a_dist, a_species, a_mask = diff, dist, species_j, nbr_mask
    ang_mask = a_mask & (a_dist < spec.angular_cutoff)
    ka = a_dist.shape[1]
    if angular_caps is not None:
        per_species = {}
        for s, cap in enumerate(angular_caps):
            if cap == 0:
                continue
            per_species[s] = _compact_onehot(ang_mask & (a_species == s),
                                             min(cap, ka), a_dist, a_diff)
        caps_eff = tuple(min(c, ka) for c in angular_caps)

        def block(rows):
            return _angular_blocked(spec, caps_eff, {
                s: tuple(x[rows] for x in v) for s, v in per_species.items()})
    else:
        args = _compact_onehot(ang_mask, min(angular_capacity, ka), a_dist,
                               a_diff, a_species)

        def block(rows):
            return _angular_generic(spec, tuple(x[rows] for x in args))

    if atom_chunk is not None and n > atom_chunk:
        angular = torch.cat([block(slice(r, min(n, r + atom_chunk)))
                             for r in range(0, n, atom_chunk)])
    else:
        angular = block(slice(None))
    aev = torch.cat([radial, angular], dim=1)
    return torch.where((species_center >= 0)[:, None], aev, 0.0)
