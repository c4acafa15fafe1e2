"""The roll-bin layout: atoms binned once per rebuild into a dense grid.

Port of lammps_ani_tpu/ops/cell_roll.py:44-126 (`RollGrid`, `RollBins`,
`build_bins`). Atoms are binned into [ncx, ncy, ncz, cap] slots; the AEV
kernels (ops/aev_roll.py) read each center's neighbor candidates from the
surrounding bins. This is rebuild-time bookkeeping (one argsort, one
searchsorted, two scatters), not a kernel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.utils.checkpoint

from ..utils.profiling import sync

_OFFSETS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
            for k in (-1, 0, 1)]


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
    with sync("bins"):
        nc = torch.as_tensor(grid.ncells, dtype=torch.int64, device=dev)
    cc = torch.minimum((frac * nc.to(frac.dtype)).to(torch.int64), nc - 1)
    cell = (cc[:, 0] * grid.ncells[1] + cc[:, 1]) * grid.ncells[2] + cc[:, 2]
    order = torch.argsort(cell, stable=True)
    sorted_cells = cell[order]
    first = torch.searchsorted(sorted_cells, sorted_cells, side="left")
    rank_sorted = torch.arange(n, device=dev) - first
    slot = torch.empty_like(rank_sorted)
    slot[order] = rank_sorted
    with sync("bins"):
        # the rows that fit their bin, by one count read back
        fit = torch.nonzero(slot < grid.cap).squeeze(1)
    species_grid = torch.full((grid.total, grid.cap), -1, dtype=torch.int32,
                              device=dev)
    species_grid[cell[fit], slot[fit]] = species[fit].to(torch.int32)
    inv = torch.full((grid.total * grid.cap,), n, dtype=torch.int64,
                     device=dev)
    inv[cell[fit] * grid.cap + slot[fit]] = fit
    return RollBins(cell=cell, slot=torch.clamp(slot, max=grid.cap - 1),
                    species_grid=species_grid, mask_grid=species_grid >= 0,
                    count_max=rank_sorted.max() + 1,
                    inv=inv.reshape(grid.total, grid.cap))


def scatter_to_grid(grid: RollGrid, bins: RollBins, x, fill=0.0):
    """[n, ...] -> [total, cap, ...] (one n-row scatter)."""
    out = x.new_full((grid.total, grid.cap) + tuple(x.shape[1:]), fill)
    return out.index_put((bins.cell, bins.slot), x)


def gather_from_grid(bins: RollBins, g):
    """[total, cap, ...] -> [n, ...] (one n-row gather)."""
    return g[bins.cell, bins.slot]


def _wrap_shift(grid: RollGrid, off) -> np.ndarray:
    """[total, 3] lattice wrap of neighbor bin c + off, in box rows: +1
    where the roll crossed the upper boundary, -1 the lower."""
    nx, ny, nz = grid.ncells
    cx, cy, cz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    out = np.zeros((nx, ny, nz, 3), np.float32)
    for d, (c, ncd) in enumerate(zip((cx, cy, cz), (nx, ny, nz))):
        t = c + off[d]
        out[..., d] = (t >= ncd).astype(np.float32) - (t < 0).astype(
            np.float32)
    return out.reshape(-1, 3)


def _roll_cells(grid: RollGrid, g, off):
    """Neighbor-bin view: the value at bin c comes from bin c + off (mod
    nc)."""
    nx, ny, nz = grid.ncells
    g4 = g.reshape(nx, ny, nz, *g.shape[1:])
    g4 = torch.roll(g4, shifts=(-off[0], -off[1], -off[2]), dims=(0, 1, 2))
    return g4.reshape(g.shape)


def _radial_basis(aev_spec, d, fc):
    """[..., R] radial terms. f64 on a uniform shift grid: the running
    product t_k = exp(-eta (x - k delta)^2) (2 exps; every intermediate is
    a basis value in (0, 1]); otherwise direct exponentials (in f32 the
    first term underflows beyond about 2.1 A and the recurrence would
    never recover)."""
    eta = aev_spec.eta_r[0]
    shf = np.asarray(aev_spec.shf_r)
    mu0 = float(shf[0])
    uniform = False
    if len(shf) > 1:
        delta = float(shf[1] - shf[0])
        uniform = np.allclose(np.diff(shf), delta, rtol=1e-6)
    if uniform and len(aev_spec.eta_r) == 1 and d.dtype == torch.float64:
        x = d - mu0
        t = torch.exp(-eta * x * x)
        b = torch.exp(2.0 * eta * delta * x)
        step = [float(np.exp(-eta * delta * delta * (2 * k - 1)))
                for k in range(len(shf))]
        terms = [t]
        for k in range(1, len(shf)):
            t = t * b * step[k]
            terms.append(t)
        out = torch.stack(terms, dim=-1)
    else:
        eta_r = torch.as_tensor(aev_spec.eta_r, dtype=d.dtype,
                                device=d.device).reshape(-1, 1)
        shf_r = torch.as_tensor(aev_spec.shf_r, dtype=d.dtype,
                                device=d.device).reshape(1, -1)
        out = torch.exp(-eta_r * (d[..., None, None] - shf_r) ** 2)
        out = out.reshape(*d.shape, -1)
    return 0.25 * out * fc[..., None]


def radial_aev_cellroll(aev_spec, grid: RollGrid, bins: RollBins, pos, box,
                        cell_chunk: int = 4096):
    """[n, S*R] radial AEV over the 27 rolled neighbor bins, in chunks of
    `cell_chunk` bins, each recomputed in the backward
    (torch.utils.checkpoint) so that its [c, cap, cap, R] pair terms are
    never all held. Differentiable w.r.t. `pos` and `box.h` by plain
    autograd."""
    spec = aev_spec
    dtype = pos.dtype
    s_count = spec.num_species
    r_len = spec.radial_sublength
    cutoff = spec.radial_cutoff
    total, cap = grid.total, grid.cap
    pos_grid = scatter_to_grid(grid, bins, pos, fill=1e6)
    onehot_all = torch.nn.functional.one_hot(
        bins.species_grid.to(torch.int64).clamp(min=0), s_count).to(dtype)
    onehot_all = onehot_all * bins.mask_grid[..., None]
    eye = torch.eye(cap, dtype=torch.bool, device=pos.device)

    def pair_chunk(my_pos, nbr_pos, nbr_oh, self_off):
        d = my_pos[:, :, None, :] - nbr_pos[:, None, :, :]
        dist = torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=1e-12))
        in_cut = dist <= cutoff
        if self_off:
            in_cut = in_cut & ~eye
        fc = torch.where(in_cut, 0.5 * torch.cos(dist * (math.pi / cutoff))
                         + 0.5, 0.0)
        # clamp before the basis: the f64 recurrence overflows at the 1e6
        # empty-slot park distance (inf * fc = 0 would be NaN)
        rt = _radial_basis(spec, torch.clamp(dist, max=cutoff + 1.0), fc)
        out = torch.einsum("zabr,zbs->zasr", rt, nbr_oh)
        return out.reshape(-1, cap, s_count * r_len)

    remat = torch.is_grad_enabled()
    acc = pos.new_zeros((total, cap, s_count * r_len))
    for off in _OFFSETS:
        shift = torch.as_tensor(_wrap_shift(grid, off), dtype=dtype,
                                device=pos.device)
        nbr_pos = _roll_cells(grid, pos_grid, off) + (shift @ box.h)[:, None]
        nbr_oh = _roll_cells(grid, onehot_all, off)
        self_off = off == (0, 0, 0)
        parts = []
        for r0 in range(0, total, cell_chunk):
            args = (pos_grid[r0:r0 + cell_chunk], nbr_pos[r0:r0 + cell_chunk],
                    nbr_oh[r0:r0 + cell_chunk], self_off)
            parts.append(torch.utils.checkpoint.checkpoint(
                pair_chunk, *args, use_reentrant=False) if remat
                else pair_chunk(*args))
        acc = acc + torch.cat(parts)
    return gather_from_grid(bins, acc)
