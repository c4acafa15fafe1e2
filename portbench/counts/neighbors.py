"""Work counted from positions: the pairs a step needs, by radius.

Never the program's lanes, tiers, sections or caps: a later change of the
program's layout leaves these counts where they are.
"""

from __future__ import annotations

import torch

from ..reference.ani import candidate_blocks


def per_atom_counts(pos, lengths, radii):
    """[n, len(radii)] int64: the neighbors of each atom within each
    radius (minimum image)."""
    pos = pos.to(torch.float64)
    lengths = lengths.to(device=pos.device, dtype=torch.float64)
    out = torch.zeros((pos.shape[0], len(radii)), dtype=torch.int64,
                      device=pos.device)
    rmax = max(radii)
    for s, e, cj, mask in candidate_blocks(pos, lengths, rmax):
        d = pos[cj] - pos[s:e, None, :]
        d = d - lengths * torch.round(d / lengths)
        r2 = (d * d).sum(-1)
        for k, r in enumerate(radii):
            out[s:e, k] = (mask & (r2 < r * r)).sum(1)
    return out


def work(cfg: dict, md: dict, species, pos, lengths) -> dict:
    """The units of work of one force evaluation at `pos`:
    atom           atoms;
    list_pair      directed pairs within max(Rcr, repulsion cutoff) + skin
                   (the pairs a rebuild must list for `rebuild_every`
                   steps);
    rad, rep, ang_nbr  directed pairs within Rcr, the repulsion cutoff and
                   Rca;
    ang_pair       unordered pairs of one center's neighbors within Rca;
    rad_col, ang_col   AEV entries of the species and species pairs
                   present (the other columns are zero);
    atom_force     atoms (a force row);
    box            one (a 3 x 3 box cotangent);
    and `species_atoms`, the atoms of each species."""
    a = cfg["aev"]
    rcr, rca = float(a["radial_cutoff"]), float(a["angular_cutoff"])
    rep = float(cfg["repulsion"]["cutoff"])
    rlist = max(rcr, rep) + float(md["skin"])
    c = per_atom_counts(pos, lengths, (rca, rcr, rep, rlist)).to(torch.float64)
    species = species.to(pos.device)
    ns = len(cfg["symbols"])
    present = int((torch.bincount(species, minlength=ns) > 0).sum())
    n = pos.shape[0]
    n_rad = len(a["eta_r"]) * len(a["shf_r"])
    n_ang = (len(a["eta_a"]) * len(a["zeta"]) * len(a["shf_a"])
             * len(a["shf_z"]))
    return {"atom": n, "list_pair": float(c[:, 3].sum()),
            "rad": float(c[:, 1].sum()), "rep": float(c[:, 2].sum()),
            "ang_nbr": float(c[:, 0].sum()),
            "ang_pair": float((c[:, 0] * (c[:, 0] - 1) / 2).sum()),
            "rad_col": n * n_rad * present,
            "ang_col": n * n_ang * present * (present + 1) // 2,
            "atom_force": n, "box": 1,
            "species_atoms": torch.bincount(species, minlength=ns).tolist()}


def mean_work(works: list) -> dict:
    """The mean of several counts (the first and last profiled step)."""
    out = {}
    for key in works[0]:
        if key == "species_atoms":
            out[key] = works[0][key]
        else:
            out[key] = sum(w[key] for w in works) / len(works)
    return out
