"""Piece timings of the roll-grid radial path at 101,250 atoms: positions
into grid rows, the materialized candidate planes, the bare radial
forward kernel on ready inputs, the output gather at widths 112 and 896,
and the whole `radial_aev_roll` forward and forward + backward.

Counterpart of examples/benchmark/micro_pieces.py on the card. The system
is the equilibrated 30-atom water tile
(examples/benchmark/data/equil_water30.npz, species O H H as
tests/fixtures.py's WATER30) replicated 15^3 times (120 A box), binned on
the coarse grid of side Rcr + 1 A (19^3 bins, cap the measured
occupancy rounded up to 4). The radial kernel is ops/aev_roll.radial_fwd
at shell 1 (one candidate group: the port has no groups).

    python -m lammps_ani_torch.probes.micro_pieces
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..models import aev as aevmod
from ..ops import aev_roll as ar
from ..ops import cell_roll as crmod
from ..ops import neighbors as nbops
from ._common import time_ms

TILE = (Path(__file__).resolve().parents[2] / "examples" / "benchmark"
        / "data" / "equil_water30.npz")
WATER30_SPECIES = np.array([3, 0, 0] * 10, np.int64)  # O H H (H=0, O=3)


def water_system(rep=15, dtype=torch.float32, device="cuda"):
    """(species [n], wrapped positions [n, 3], Box, species counts) of the
    tile replicated rep^3 times."""
    z = np.load(TILE)
    h0 = np.asarray(z["box_h"], np.float64)
    shifts = np.array([[i, j, k] for i in range(rep) for j in range(rep)
                       for k in range(rep)], np.float64) @ h0
    pos = (np.asarray(z["positions"], np.float64)[None] + shifts[:, None]
           ).reshape(-1, 3)
    species = np.tile(WATER30_SPECIES, rep ** 3)
    box = nbops.Box(h=torch.tensor(h0 * rep, dtype=dtype, device=device),
                    origin=torch.tensor(z["box_origin"], dtype=dtype,
                                        device=device))
    pos_t = nbops.wrap_positions(
        torch.tensor(pos, dtype=dtype, device=device), box)
    counts = tuple(int((species == s).sum()) for s in range(7))
    return (torch.as_tensor(species, device=device), pos_t, box, counts)


def coarse_grid(species, pos, box, side):
    """The roll grid of bins at least `side` wide, cap the measured
    occupancy rounded up to 4, and the bins."""
    h = box.h.detach().cpu().numpy().astype(np.float64)
    probe = crmod.RollGrid.for_box(h, side, 64)
    cnt = int(crmod.build_bins(probe, pos, species, box).count_max)
    grid = crmod.RollGrid(ncells=probe.ncells, cap=-(-cnt // 4) * 4)
    return grid, crmod.build_bins(grid, pos, species, box)


def setup(rep=15, device="cuda"):
    """The system, grid and the radial kernel's ready inputs."""
    spec = aevmod.ani2x_aev_spec()
    species, pos, box, counts = water_system(rep, device=device)
    grid, bins = coarse_grid(species, pos, box, spec.radial_cutoff + 1.0)
    pos_g, sp_g = ar._grid_inputs(bins.inv, pos, bins.species_grid)
    return dict(spec=spec, species=species, pos=pos, box=box,
                counts=counts, grid=grid, bins=bins, pos_g=pos_g, sp_g=sp_g,
                h=box.h.contiguous(),
                present=ar.present_species(spec, counts))


def bare_call(s):
    """The radial forward kernel on ready grid inputs (shell 1)."""
    return lambda: ar.radial_fwd(s["pos_g"], s["sp_g"], s["h"],
                                 s["grid"].ncells, 1, s["spec"],
                                 s["present"])


def bare_kernel(reps=10, device="cuda", s=None) -> dict:
    """ms of the bare radial forward kernel at the main size."""
    s = s or setup(device=device)
    return {"atoms": int(s["pos"].shape[0]),
            "ncells": list(s["grid"].ncells), "cap": s["grid"].cap,
            "ms": time_ms(bare_call(s), reps=reps)}


def pieces(reps=10, device="cuda", s=None) -> dict:
    """ms of each piece at the main size (CUDA events over `reps`
    calls)."""
    s = s or setup(device=device)
    spec, grid, bins, pos, box = (s["spec"], s["grid"], s["bins"],
                                  s["pos"], s["box"])
    nx, ny, nz = grid.ncells
    res = {"atoms": int(pos.shape[0]), "ncells": [nx, ny, nz],
           "cap": grid.cap}
    res["to_grid_rows"] = time_ms(
        lambda: ar._to_grid_rows(bins.inv, pos, 1e6), reps=reps)

    def cands():
        pos_g = ar._to_grid_rows(bins.inv, pos, 1e6)
        return ar._candidates(grid.ncells, pos_g, s["sp_g"], s["h"], 1)

    res["grid_rows_and_candidates"] = time_ms(cands, reps=reps)
    res["bare_radial_fwd"] = time_ms(bare_call(s), reps=reps)
    g = torch.Generator(device=device).manual_seed(0)
    for width in (112, 896):
        gg = torch.randn((grid.total, grid.cap, width), generator=g,
                         device=device)
        res[f"out_gather_{width}"] = time_ms(
            lambda: gg[bins.cell, bins.slot], reps=reps)
        del gg
    fwd = lambda p: ar.radial_aev_roll(spec, grid, bins, p, box,
                                       species_counts=s["counts"], shell=1)
    res["radial_aev_roll_fwd"] = time_ms(lambda: fwd(pos), reps=reps)
    cot = torch.randn((pos.shape[0], spec.radial_length), generator=g,
                      device=device)

    def fwd_bwd():
        p = pos.detach().requires_grad_(True)
        return torch.autograd.grad((fwd(p) * cot).sum(), p)

    res["radial_aev_roll_fwd_bwd"] = time_ms(fwd_bwd, reps=reps)
    return res


def main(argv=None) -> int:
    print(json.dumps(pieces()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
