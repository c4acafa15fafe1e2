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
the generic oracle the kernels of ops/aev_roll.py are held against.
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


def angular_terms(spec: AEVSpec, r12: torch.Tensor, r13: torch.Tensor,
                  cos_theta: torch.Tensor) -> torch.Tensor:
    """[..., n_angular_sub] angular basis values, torchani channel order
    (eta_a, zeta, shf_a, shf_z). cos(theta - shf) is expanded with
    cos(theta) = 0.95 cos_theta, sin(theta) = sqrt(1 - cos(theta)^2)."""
    t = dict(dtype=r12.dtype, device=r12.device)
    zeta = torch.as_tensor(spec.zeta, **t).reshape(-1, 1)
    cz = torch.as_tensor(np.cos(spec.shf_z), **t).reshape(1, -1)
    sz = torch.as_tensor(np.sin(spec.shf_z), **t).reshape(1, -1)
    c = 0.95 * torch.clamp(cos_theta, -1.0, 1.0)
    s = torch.sqrt(1.0 - c * c)
    base = 0.5 * (1.0 + c[..., None, None] * cz + s[..., None, None] * sz)
    if len(spec.zeta) == 1:
        f1 = _zeta_pow(base, spec.zeta[0])
    else:
        f1 = base ** zeta
    f1 = f1.reshape(*cos_theta.shape, -1)  # [..., Z*S]

    eta_a = torch.as_tensor(spec.eta_a, **t).reshape(-1, 1)
    shf_a = torch.as_tensor(spec.shf_a, **t).reshape(1, -1)
    rmean = 0.5 * (r12 + r13)
    fc = (cutoff_cosine(r12, spec.angular_cutoff)
          * cutoff_cosine(r13, spec.angular_cutoff))
    f2 = torch.exp(-eta_a * (rmean[..., None, None] - shf_a) ** 2)
    f2 = (f2 * fc[..., None, None]).reshape(*r12.shape, -1)  # [..., E*A]

    ne, nz = len(spec.eta_a), len(spec.zeta)
    na, ns = len(spec.shf_a), len(spec.shf_z)
    out = f2[..., :, None] * f1[..., None, :]
    out = out.reshape(*r12.shape, ne, na, nz, ns).transpose(-3, -2)
    return 2.0 * out.reshape(*r12.shape, spec.angular_sublength)


def _compact(mask: torch.Tensor, capacity: int, *xs: torch.Tensor):
    """Left-compact the masked slots of each row into `capacity` columns,
    keeping ascending slot order; slots ranked past `capacity` are dropped.
    Returns (mask_c, *xs_c), empty columns zero."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    keep = mask & (rank < capacity)
    rows = torch.arange(n, device=mask.device)[:, None].expand_as(mask)
    mask_c = torch.zeros((n, capacity), dtype=torch.bool, device=mask.device)
    mask_c[rows[keep], rank[keep]] = True
    outs = []
    for x in xs:
        xc = x.new_zeros((n, capacity) + x.shape[2:])
        xc = xc.index_put((rows[keep], rank[keep]), x[keep])
        outs.append(xc)
    return (mask_c, *outs)


def compute_aev(spec: AEVSpec, species_center: torch.Tensor,
                diff: torch.Tensor, dist: torch.Tensor,
                species_j: torch.Tensor, nbr_mask: torch.Tensor, *,
                angular_capacity: int = 32) -> torch.Tensor:
    """[n, aev_length] over a padded full neighbor matrix (the generic
    oracle). diff[i, k] = pos_i - pos_j; invalid slots masked.
    Differentiable w.r.t. `diff` and `dist`."""
    n, k = dist.shape
    dtype = dist.dtype
    big = 2.0 * spec.radial_cutoff + 10.0
    dist = torch.where(nbr_mask, dist, big)
    species_j = torch.where(nbr_mask, species_j, 0).to(torch.int64)

    rterms = radial_terms(spec, dist)
    rterms = torch.where(nbr_mask[..., None], rterms, 0.0)
    onehot = torch.nn.functional.one_hot(species_j, spec.num_species).to(dtype)
    onehot = onehot * nbr_mask[..., None]
    radial = torch.einsum("nks,nkr->nsr", onehot, rterms).reshape(
        n, spec.radial_length)

    ang_mask = nbr_mask & (dist < spec.angular_cutoff)
    cap = min(angular_capacity, k)
    mask_c, diff_c, dist_c, sp_c = _compact(ang_mask, cap, diff, dist,
                                            species_j)
    safe = torch.where(mask_c, dist_c, 1.0)
    unit = torch.where(mask_c[..., None], diff_c / safe[..., None], 0.0)
    safe = torch.where(mask_c, dist_c, 2.0 * spec.angular_cutoff + 10.0)
    tri_k, tri_l = np.triu_indices(cap, 1)
    tri_k = torch.as_tensor(tri_k, device=dist.device)
    tri_l = torch.as_tensor(tri_l, device=dist.device)
    cos_kl = torch.sum(unit[:, tri_k] * unit[:, tri_l], dim=-1)
    aterms = angular_terms(spec, safe[:, tri_k], safe[:, tri_l], cos_kl)
    triu = torch.as_tensor(spec.triu_index(), dtype=torch.int64,
                           device=dist.device)
    pair = triu[sp_c[:, tri_k], sp_c[:, tri_l]]
    onehot_p = torch.nn.functional.one_hot(pair, spec.num_pairs).to(dtype)
    angular = torch.einsum("cqp,cqa->cpa", onehot_p, aterms).reshape(
        n, spec.angular_length)

    aev = torch.cat([radial, angular], dim=1)
    return torch.where((species_center >= 0)[:, None], aev, 0.0)
