"""The roll-bin layout: atoms binned once per rebuild into a dense grid.

Port of lammps_ani_tpu/ops/cell_roll.py:44-126 (`RollGrid`, `RollBins`,
`build_bins`). Atoms are binned into [ncx, ncy, ncz, cap] slots; the AEV
kernels (ops/aev_roll.py) read each center's neighbor candidates from the
surrounding bins. This is rebuild-time bookkeeping (one argsort, one
searchsorted, two scatters), not a kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RollGrid:
    """Static bin geometry."""

    ncells: tuple[int, int, int]
    cap: int

    @property
    def total(self) -> int:
        nx, ny, nz = self.ncells
        return nx * ny * nz

    @staticmethod
    def for_box(box_h, side_min: float, cap: int):
        """Bins at least `side_min` wide; None if fewer than 3 per axis."""
        h = np.asarray(box_h, np.float64)
        v = abs(np.dot(h[0], np.cross(h[1], h[2])))
        perp = np.array([
            v / np.linalg.norm(np.cross(h[1], h[2])),
            v / np.linalg.norm(np.cross(h[2], h[0])),
            v / np.linalg.norm(np.cross(h[0], h[1])),
        ])
        nc = np.floor(perp / side_min).astype(int)
        if (nc < 3).any():
            return None
        return RollGrid(ncells=tuple(int(x) for x in nc), cap=cap)


@dataclasses.dataclass(frozen=True)
class RollBins:
    """Rebuild-frozen atom -> bin assignment.

    `inv` is the inverse map (grid slot -> atom row, n for empty slots)."""

    cell: torch.Tensor  # [n] int64 flat bin id
    slot: torch.Tensor  # [n] int64 slot within bin (clipped to cap - 1)
    species_grid: torch.Tensor  # [total, cap] int32, -1 empty
    mask_grid: torch.Tensor  # [total, cap] bool
    count_max: torch.Tensor  # [] int64 (overflow if > cap)
    inv: torch.Tensor  # [total, cap] int64 atom row (n = empty)


def build_bins(grid: RollGrid, pos: torch.Tensor, species: torch.Tensor,
               box) -> RollBins:
    """Assign atoms to bins: slot = stable rank of the atom among atoms of
    the same bin (atoms in input order)."""
    n = pos.shape[0]
    dev = pos.device
    frac = box.to_fractional(pos)
    frac = frac - torch.floor(frac)
    nc = torch.as_tensor(grid.ncells, dtype=torch.int64, device=dev)
    cc = torch.minimum((frac * nc.to(frac.dtype)).to(torch.int64), nc - 1)
    cell = (cc[:, 0] * grid.ncells[1] + cc[:, 1]) * grid.ncells[2] + cc[:, 2]
    order = torch.argsort(cell, stable=True)
    sorted_cells = cell[order]
    first = torch.searchsorted(sorted_cells, sorted_cells, side="left")
    rank_sorted = torch.arange(n, device=dev) - first
    slot = torch.empty_like(rank_sorted)
    slot[order] = rank_sorted
    ok = slot < grid.cap
    species_grid = torch.full((grid.total, grid.cap), -1, dtype=torch.int32,
                              device=dev)
    species_grid[cell[ok], slot[ok]] = species[ok].to(torch.int32)
    inv = torch.full((grid.total * grid.cap,), n, dtype=torch.int64,
                     device=dev)
    inv[cell[ok] * grid.cap + slot[ok]] = torch.arange(n, device=dev)[ok]
    return RollBins(cell=cell, slot=torch.clamp(slot, max=grid.cap - 1),
                    species_grid=species_grid, mask_grid=species_grid >= 0,
                    count_max=rank_sorted.max() + 1,
                    inv=inv.reshape(grid.total, grid.cap))
