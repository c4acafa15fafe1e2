"""O(N) binned cell-list neighbor construction.

Port of lammps_ani_tpu/ops/cell_list.py: a dense [n_cells, capacity]
cell table built by one sort + rank-by-searchsorted + scatter, queried
over each atom's 27-cell window, pruned to the cutoff and compacted
closest-first to `k_max` slots. Same output contract as
ops/neighbors.build_neighbor_matrix_brute. In the port it serves the
degree measure at `use_cell_list=True` (a brute matrix at 100k atoms does
not fit in memory).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import neighbors as nbops


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """Static cell-grid geometry over the primary cell expanded by the
    ghost margin: axis i spans [-margin_frac[i], 1 + margin_frac[i])."""

    ncells: tuple[int, int, int]
    margin_frac: tuple[float, float, float]
    cell_capacity: int

    @property
    def total_cells(self) -> int:
        nx, ny, nz = self.ncells
        return nx * ny * nz

    @staticmethod
    def for_box(box_h, rlist: float, cell_capacity: int,
                target_cell_side: float | None = None) -> "CellGrid | None":
        """None if the box is too small (fewer than 3 cells on an axis)."""
        h = np.asarray(box_h, np.float64)
        v = abs(np.dot(h[0], np.cross(h[1], h[2])))
        perp = np.array([
            v / np.linalg.norm(np.cross(h[1], h[2])),
            v / np.linalg.norm(np.cross(h[2], h[0])),
            v / np.linalg.norm(np.cross(h[0], h[1])),
        ])
        side = target_cell_side or rlist
        margin_frac = rlist / perp
        ncells = []
        for i in range(3):
            n = int(math.floor(perp[i] * (1.0 + 2.0 * margin_frac[i]) / side))
            if n < 3:
                return None
            ncells.append(n)
        return CellGrid(ncells=tuple(ncells),
                        margin_frac=tuple(float(m) for m in margin_frac),
                        cell_capacity=cell_capacity)


def _cell_coords(grid: CellGrid, frac: torch.Tensor) -> torch.Tensor:
    """[m, 3] integer cell coords for fractional positions (clipped)."""
    out = []
    for i in range(3):
        m = grid.margin_frac[i]
        n = grid.ncells[i]
        u = (frac[..., i] + m) / (1.0 + 2.0 * m)
        out.append(torch.clamp(torch.floor(u * n).to(torch.int64), 0, n - 1))
    return torch.stack(out, dim=-1)


def _flat_cell(grid: CellGrid, coords: torch.Tensor) -> torch.Tensor:
    _, ny, nz = grid.ncells
    return (coords[..., 0] * ny + coords[..., 1]) * nz + coords[..., 2]


def build_cell_table(grid: CellGrid, cell_ids: torch.Tensor,
                     valid: torch.Tensor):
    """(table [n_cells, capacity] of atom indices, sentinel = m;
    max_cell_count) for overflow detection."""
    m = cell_ids.shape[0]
    dev = cell_ids.device
    sentinel = grid.total_cells
    ids = torch.where(valid, cell_ids, sentinel)
    order = torch.argsort(ids, stable=True)
    ids_sorted = ids[order]
    first = torch.searchsorted(ids_sorted, ids_sorted, side="left")
    rank = torch.arange(m, device=dev) - first
    in_grid = ids_sorted < sentinel
    ok = (rank < grid.cell_capacity) & in_grid
    table = torch.full((grid.total_cells + 1, grid.cell_capacity), m,
                       dtype=torch.int64, device=dev)
    table[ids_sorted[ok], rank[ok]] = order[ok]
    max_count = torch.where(in_grid, rank, -1).max() + 1
    return table[:-1], max_count


_NEIGHBOR_OFFSETS = np.array(
    [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    np.int64)


def build_neighbor_matrix_cells(pos: torch.Tensor, box: nbops.Box,
                                rlist: float, k_max: int,
                                ghosts: nbops.Ghosts, *, grid: CellGrid,
                                atom_chunk: int = 4096) -> nbops.NeighborList:
    """Cell-list neighbor build; same output contract as the brute build
    (pairs selected by the mirror-symmetric `pair_displacements`)."""
    n = pos.shape[0]
    dev = pos.device
    pos_ext = nbops.extended_positions(pos, box, ghosts)
    m = pos_ext.shape[0]
    ext_valid = torch.cat([torch.ones((n,), dtype=torch.bool, device=dev),
                           ghosts.mask])
    coords = _cell_coords(grid, box.to_fractional(pos_ext))
    table, max_cell_count = build_cell_table(grid, _flat_cell(grid, coords),
                                             ext_valid)
    offsets = torch.as_tensor(_NEIGHBOR_OFFSETS, device=dev)
    ncells = torch.as_tensor(grid.ncells, dtype=torch.int64, device=dev)
    n_cand = 27 * grid.cell_capacity
    idx_out, mask_out, degs = [], [], []
    for start in range(0, n, atom_chunk):
        idx_c = torch.arange(start, min(start + atom_chunk, n), device=dev)
        nbr_cells = coords[idx_c][:, None, :] + offsets[None]
        # cells outside the grid hold nothing: mask them (clipping would
        # alias edge cells and duplicate their atoms)
        in_grid = torch.all((nbr_cells >= 0) & (nbr_cells < ncells), dim=-1)
        nbr_flat = _flat_cell(grid, torch.minimum(
            torch.clamp(nbr_cells, min=0), ncells - 1))
        cand = torch.where(in_grid[..., None], table[nbr_flat], m)
        cand = cand.reshape(-1, n_cand)
        cand_safe = torch.clamp(cand, max=m - 1)
        d = nbops.pair_displacements(pos, box, ghosts, idx_c, cand_safe)
        dist2 = torch.sum(d * d, dim=-1)
        mask = (cand < m) & (dist2 < rlist ** 2) & (cand != idx_c[:, None])
        degs.append(mask.sum(dim=1).max())
        key = torch.where(mask, dist2, float("inf"))
        neg_key, sel = nbops._closest_k(key, k_max)
        nbr_mask = torch.isfinite(neg_key)
        nbr_idx = torch.where(nbr_mask, torch.gather(cand_safe, 1, sel), 0)
        idx_out.append(nbr_idx)
        mask_out.append(nbr_mask)
    max_deg = torch.stack(degs).max()
    # a clipped cell table silently drops candidates: report k_max + 1
    max_deg = torch.where(max_cell_count > grid.cell_capacity,
                          torch.as_tensor(k_max + 1, device=dev), max_deg)
    return nbops.NeighborList(idx=torch.cat(idx_out), mask=torch.cat(mask_out),
                              ghosts=ghosts, max_count=max_deg)

