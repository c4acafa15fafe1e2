"""Reactive-trajectory fragment analysis (the combustion analyze.py).

Port of lammps_ani_tpu/analysis/fragments.py: bond table by element-pair
cutoffs (the reference analyze.py's BOND_CUTOFFS) -> connected components
-> molecular formula time series.

The JAX package tests every pair on the host (O(n^2)). Here `bond_pairs`
finds candidate pairs on the device: the atoms are binned into a periodic
grid of cells of side >= the largest cutoff by the port's cell list
(ops/cell_list.py), and each atom's 27-cell window gives the pairs within
that cutoff by the minimum image. The JAX test is then applied to those
candidates exactly, in f64 on the host: minimum image as (frac -
round(frac)) @ h, r < cut and r < rmax. So the pairs, the components
(scipy) and the formulas are the JAX package's.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch
from scipy import sparse
from scipy.sparse.csgraph import connected_components

from .._device import resolve_device
from ..ops import cell_list as clmod
from ..ops.neighbors import min_image

# element-pair bond cutoffs in Angstrom (reference analyze.py BOND_CUTOFFS)
DEFAULT_CUTOFFS = {
    ("H", "H"): 0.84, ("H", "C"): 1.42, ("H", "N"): 1.31, ("H", "O"): 1.26,
    ("C", "C"): 1.98, ("C", "N"): 1.90, ("C", "O"): 1.86,
    ("N", "N"): 1.82, ("N", "O"): 1.78, ("O", "O"): 1.74,
}
SYMBOLS = ("H", "C", "N", "O")
# the device's loose test keeps pairs this far past rmax (relative), so
# no pair the host's exact test keeps is lost to rounding
_LOOSE = 1e-6
_ATOM_CHUNK = 16384


def _cutoff_matrix(symbols, cutoffs):
    s = len(symbols)
    m = np.zeros((s, s))
    for (a, b), r in cutoffs.items():
        if a in symbols and b in symbols:
            i, j = symbols.index(a), symbols.index(b)
            m[i, j] = m[j, i] = r
    return m


def _perp(h):
    v = abs(np.dot(h[0], np.cross(h[1], h[2])))
    return np.array([v / np.linalg.norm(np.cross(h[1], h[2])),
                     v / np.linalg.norm(np.cross(h[2], h[0])),
                     v / np.linalg.norm(np.cross(h[0], h[1]))])


def _candidates(pos, h, periodic, rmax, device):
    """(i, j) numpy arrays, i < j, of the pairs within rmax (1 + _LOOSE) by
    the minimum image (the plain difference where not `periodic`), from
    each atom's 27-cell window of a periodic grid over the cell `h`."""
    n = pos.shape[0]
    ncells = tuple(int(c) for c in np.maximum(
        np.floor(_perp(h) / rmax), 1).astype(np.int64))
    t = dict(dtype=torch.float64, device=device)
    pos_t = torch.as_tensor(pos, **t)
    h_t = torch.as_tensor(h, **t)
    hinv_t = torch.as_tensor(np.linalg.inv(h), **t)
    frac = pos_t @ hinv_t
    grid = clmod.CellGrid(ncells=ncells, margin_frac=(0.0, 0.0, 0.0),
                          cell_capacity=1)
    coords = clmod._cell_coords(grid, frac - torch.floor(frac))
    ids = clmod._flat_cell(grid, coords)
    cap = int(torch.bincount(ids, minlength=grid.total_cells).max())
    grid = clmod.CellGrid(ncells=ncells, margin_frac=(0.0, 0.0, 0.0),
                          cell_capacity=cap)
    valid = torch.ones((n,), dtype=torch.bool, device=device)
    table, _ = clmod.build_cell_table(grid, ids, valid)
    # each distinct neighbor cell once (an axis of one or two cells has
    # fewer than three)
    per_axis = [sorted({o % c for o in (-1, 0, 1)}) for c in ncells]
    offs = torch.as_tensor([(a, b, c) for a in per_axis[0]
                            for b in per_axis[1] for c in per_axis[2]],
                           device=device)
    nc = torch.as_tensor(ncells, device=device)
    lim2 = (rmax * (1.0 + _LOOSE)) ** 2
    out_i, out_j = [], []
    for start in range(0, n, _ATOM_CHUNK):
        i = torch.arange(start, min(start + _ATOM_CHUNK, n), device=device)
        cells = clmod._flat_cell(grid, (coords[i][:, None, :] + offs) % nc)
        cand = table[cells].reshape(i.shape[0], -1)
        keep = (cand < n) & (cand > i[:, None])
        ii = i[:, None].expand_as(cand)[keep]
        jj = cand[keep]
        d = pos_t[jj] - pos_t[ii]
        if periodic:
            d = min_image(d, h_t, hinv_t)
        near = torch.sum(d * d, dim=1) < lim2
        out_i.append(ii[near])
        out_j.append(jj[near])
    return (torch.cat(out_i).cpu().numpy(), torch.cat(out_j).cpu().numpy())


def bond_pairs(species, pos, box_h=None, symbols=SYMBOLS,
               cutoffs=DEFAULT_CUTOFFS, device=None):
    """[(i, j)] bonded pairs, i < j, sorted, under element-pair cutoffs
    (minimum image where `box_h` is given). Candidates on `device` (the
    card unless it says otherwise), the exact test on the host."""
    cm = _cutoff_matrix(list(symbols), cutoffs)
    rmax = float(cm.max())
    pos = np.asarray(pos, np.float64)
    species = np.asarray(species)
    if len(pos) < 2 or rmax <= 0.0:
        return []
    periodic = box_h is not None
    if periodic:
        h = np.asarray(box_h, np.float64)
        i, j = _candidates(pos, h, True, rmax, resolve_device(device))
    else:
        # an open system: a cell wider than its extent by 2 rmax, so no
        # wrapped window brings a far atom near
        rel = pos - pos.min(0)
        i, j = _candidates(rel, np.diag(rel.max(0) + 2.0 * rmax), False,
                           rmax, resolve_device(device))
    d = pos[j] - pos[i]
    if periodic:
        frac = d @ np.linalg.inv(h)
        d = (frac - np.round(frac)) @ h
    r = np.linalg.norm(d, axis=1)
    keep = (r < cm[species[i], species[j]]) & (r < rmax)
    i, j = i[keep], j[keep]
    order = np.lexsort((j, i))
    return list(zip(i[order].tolist(), j[order].tolist()))


def fragments(species, pos, box_h=None, symbols=SYMBOLS,
              cutoffs=DEFAULT_CUTOFFS, device=None):
    """(labels [n], formulas Counter): connected components -> formulas,
    in the order of `symbols` (e.g. 'H2O1', as the reference's
    analyze.py builds them)."""
    species = np.asarray(species)
    n = len(pos)
    pairs = bond_pairs(species, pos, box_h, symbols, cutoffs, device)
    if pairs:
        ij = np.asarray(pairs)
        adj = sparse.coo_matrix(
            (np.ones(len(ij)), (ij[:, 0], ij[:, 1])), shape=(n, n))
        _, labels = connected_components(adj, directed=False)
    else:
        labels = np.arange(n)
    n_sym = len(symbols)
    counts = np.bincount(labels * n_sym + species,
                         minlength=(labels.max() + 1) * n_sym
                         ).reshape(-1, n_sym)
    formulas = Counter()
    for row in counts[np.unique(labels)]:
        formulas["".join(f"{sym}{c}" for sym, c in zip(symbols, row)
                         if c)] += 1
    return labels, formulas


def formula_time_series(frames, species, box_h=None, symbols=SYMBOLS,
                        cutoffs=DEFAULT_CUTOFFS, device=None):
    """[{formula: count}] per frame: the reference's reaction-network time
    series (combustion, early-earth glycine detection)."""
    return [fragments(species, f, box_h, symbols, cutoffs, device)[1]
            for f in frames]
