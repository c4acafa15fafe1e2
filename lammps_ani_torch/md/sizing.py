"""Capacity sizing shared by the single-device engine (md/simulation.py)
and the sharded one (parallel/sim.py): the grid slack under a barostat,
the margins of the measured degrees, their rounding to angular caps, and
the per-species degree measure over a neighbor matrix. Each engine keeps
its own neighbor build, bin-cap margin and tier model."""

from __future__ import annotations

import torch

from ..ops import neighbors as nbops

# Grid slack under a barostat: the box may shrink this much before the
# grids are re-derived.
BAROSTAT_SLACK = 1.06
# Multiplicative margin of the measured per-species angular degrees.
ANG_CAP_MARGIN = 1.1
# asn engine: margin of the measured keep-radius degrees (the sections).
SEC_MARGIN = 1.1


def ceil_to(x, m) -> int:
    return int(-(-int(x) // m) * m)


def angular_caps(degrees, margin: float) -> tuple:
    """Per-species angular caps from the measured per-species degrees
    within Rca: +margin and +2, +4 more for small degrees, rounded to 4;
    0 for species absent as neighbors."""
    return tuple(0 if d == 0 else ceil_to(
        int(d * margin + 2 + (4 if d * margin <= 10 else 0)), 4)
        for d in degrees)


def degree_measure(spec, pos, box, nlist, species_ext,
                   keep_radius: float | None = None):
    """One measure over the neighbor matrix `nlist` of the wrapped
    positions `pos`: (dist [n, k], mask of the real neighbors [n, k], the
    per-row degrees within Rca by neighbor species [n, S], and the
    per-species largest degree within `keep_radius`, a list, or None
    where no radius is given)."""
    _, dist = nbops.neighbor_displacements(pos, box, nlist)
    species_j = species_ext[nlist.idx]
    mask = nlist.mask & (species_j >= 0)
    in_ang = mask & (dist < spec.aev.angular_cutoff)
    n_sp = spec.aev.num_species
    cnt = torch.stack([torch.sum(in_ang & (species_j == s), dim=1)
                       for s in range(n_sp)], dim=1)
    keep = None
    if keep_radius is not None:
        in_keep = mask & (dist < keep_radius)
        keep = [int(torch.sum(in_keep & (species_j == s), dim=1).max())
                for s in range(n_sp)]
    return dist, mask, cnt, keep
