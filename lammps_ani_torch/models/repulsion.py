"""XTB-style pairwise repulsion (GFN1-xTB), the ANI-2x/ANI-1xnr core wall.

Port of lammps_ani_tpu/models/repulsion.py:

    E_rep = sum_{A<B} (Zeff_A Zeff_B / R_AB) exp(-sqrt(alpha_A alpha_B)
                                                 R_AB^{k_f})   [atomic units]

with a smooth cutoff envelope, distances in bohr, energies in Hartree.
`repulsion_energies` is the plain neighbor-matrix form; the asn fast path
computes the same pair energies inside its step kernel
(ops/aev_asn.step_fused) and is tested against this one.
"""

from __future__ import annotations

import dataclasses

import torch

ANGSTROM2BOHR = 1.8897261258369282

# GFN1-xTB repulsion parameters (alpha, Z_eff) for the ANI element set.
_GFN1_ALPHA = {
    "H": 2.209700, "C": 1.189666, "N": 1.371674, "O": 1.620185,
    "S": 1.026602, "F": 2.035341, "Cl": 1.173032,
}
_GFN1_ZEFF = {
    "H": 1.116244, "C": 4.428763, "N": 5.498808, "O": 5.171786,
    "S": 15.100323, "F": 6.931741, "Cl": 17.000000,
}


@dataclasses.dataclass(frozen=True)
class RepulsionSpec:
    """Static repulsion parameters for a species set (index-aligned)."""

    alpha: tuple[float, ...]
    zeff: tuple[float, ...]
    cutoff: float  # Angstrom
    k_f: float = 1.5
    cutoff_fn: str = "smooth"  # "smooth" | "cosine" | "none"

    @staticmethod
    def for_symbols(symbols, cutoff: float = 5.1, cutoff_fn: str = "smooth"):
        return RepulsionSpec(
            alpha=tuple(_GFN1_ALPHA[s] for s in symbols),
            zeff=tuple(_GFN1_ZEFF[s] for s in symbols),
            cutoff=cutoff,
            cutoff_fn=cutoff_fn,
        )


def _cutoff_envelope(spec: RepulsionSpec, r: torch.Tensor) -> torch.Tensor:
    x = r / spec.cutoff
    if spec.cutoff_fn == "none":
        return (x < 1.0).to(r.dtype)
    if spec.cutoff_fn == "cosine":
        return torch.where(x < 1.0, 0.5 * torch.cos(torch.pi * x) + 0.5, 0.0)
    # "smooth": exponential bump, C-infinity at the cutoff
    x2 = torch.clamp(x * x, 0.0, 1.0 - 1e-6)
    return torch.where(x < 1.0, torch.exp(1.0 - 1.0 / (1.0 - x2)), 0.0)


def repulsion_energies(spec: RepulsionSpec, species_center: torch.Tensor,
                       species_j: torch.Tensor, dist: torch.Tensor,
                       nbr_mask: torch.Tensor, ghost_center: torch.Tensor,
                       ghost_j: torch.Tensor) -> torch.Tensor:
    """[n] per-atom repulsion energies in Hartree over a neighbor matrix
    (`species_j`, `dist`, `nbr_mask` [n, k]): each atom gets half of every
    pair it takes part in; ghost or padding centers get nothing."""
    del ghost_j  # a ghost neighbor's pair is halved like any other
    dtype = dist.dtype
    alpha = torch.as_tensor(spec.alpha, dtype=dtype, device=dist.device)
    zeff = torch.as_tensor(spec.zeff, dtype=dtype, device=dist.device)
    si = torch.clamp(species_center, 0, len(spec.alpha) - 1).long()
    sj = torch.clamp(species_j, 0, len(spec.alpha) - 1).long()
    valid = (nbr_mask & (species_center >= 0)[:, None]
             & ~ghost_center[:, None] & (dist < spec.cutoff))
    r_bohr = dist * ANGSTROM2BOHR
    a_ij = torch.sqrt(alpha[si][:, None] * alpha[sj])
    z_ij = zeff[si][:, None] * zeff[sj]
    safe_r = torch.where(valid, r_bohr, 1.0)
    e_pair = z_ij / safe_r * torch.exp(-a_ij * safe_r ** spec.k_f)
    e_pair = e_pair * _cutoff_envelope(spec, dist)
    e_pair = torch.where(valid, e_pair, 0.0)
    return 0.5 * torch.sum(e_pair, dim=1)
