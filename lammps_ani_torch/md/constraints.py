"""RATTLE bond-length constraints (LAMMPS `fix shake` equivalent).

Port of lammps_ani_tpu/md/constraints.py. The velocity-Verlet constraint
projection is RATTLE with Jacobi (parallel) iterations: every constraint
updates at once with mass-weighted corrections, a fixed count of them
(`iters`), so the step has no data-dependent control flow and no read
back to the host.

Constraint semantics: minimum-image bond vectors through inv(h) of the box
passed in (recomputed at every call: a barostat changes the box every
step), so molecules may straddle periodic faces. dof accounting:
`Simulation` subtracts one dof per constraint.

The atom updates run in a fixed order, so two runs on the card give the
same bits: the first call for a device, dtype and atom count builds a
per-atom table of (constraint, sign) padded to the largest degree (2 for
water's O), and each iteration sums an atom's corrections through it with
a gather and a sum over that small axis (no scatter, no float atomics).
inv(h) is taken once per call, outside the iterations.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.neighbors import cell_inverse, min_image


@dataclasses.dataclass(frozen=True)
class _Tables:
    i: torch.Tensor  # [m] int64
    j: torch.Tensor  # [m] int64
    r0: torch.Tensor  # [m]
    slot: torch.Tensor  # [n, D] int64 constraint per slot (0: padding)
    sign: torch.Tensor  # [n, D] -1 (the i side), +1 (the j side), 0 (pad)


@dataclasses.dataclass(frozen=True)
class Rattle:
    """Static constraint set: bonds (i, j) fixed at length r0."""

    pairs: tuple  # ((i, j), ...)
    r0: tuple  # (float, ...)
    iters: int = 30
    tol: float = 1e-8  # informational; iterations are fixed-count
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     compare=False, repr=False)

    @staticmethod
    def from_bonds(bonds, positions, box_h=None) -> "Rattle":
        """Constrain the given (i, j) pairs (the last two entries of each
        row) at their current minimum-image lengths, taken in f64."""
        pos = np.asarray(positions, np.float64)
        pairs = np.asarray([(int(b[-2]), int(b[-1])) for b in bonds],
                           np.int64).reshape(-1, 2)
        d = pos[pairs[:, 0]] - pos[pairs[:, 1]]
        if box_h is not None:
            h = np.asarray(box_h, np.float64)
            frac = d @ np.linalg.inv(h)
            d = (frac - np.round(frac)) @ h
        return Rattle(pairs=tuple(map(tuple, pairs.tolist())),
                      r0=tuple(np.linalg.norm(d, axis=1).tolist()))

    @property
    def n_constraints(self) -> int:
        return len(self.pairs)

    def tables(self, n_atoms: int, dtype, device) -> _Tables:
        """The index tensors and the per-atom (constraint, sign) table on
        `device`, built once per (device, dtype, n_atoms)."""
        key = (str(torch.device(device)), dtype, n_atoms)
        tab = self._cache.get(key)
        if tab is not None:
            return tab
        ij = np.asarray(self.pairs, np.int64).reshape(-1, 2)
        m = ij.shape[0]
        atoms = np.concatenate([ij[:, 0], ij[:, 1]])
        cons = np.concatenate([np.arange(m), np.arange(m)])
        signs = np.concatenate([-np.ones(m), np.ones(m)])
        # slot rank of each (atom, constraint) entry, in constraint order:
        # the i side before the j side of the same constraint index
        order = np.lexsort((signs, cons, atoms))
        atoms, cons, signs = atoms[order], cons[order], signs[order]
        deg = np.bincount(atoms, minlength=n_atoms)
        width = max(int(deg.max()) if m else 0, 1)
        first = np.concatenate([[0], np.cumsum(deg)[:-1]])
        rank = np.arange(atoms.size) - first[atoms]
        slot = np.zeros((n_atoms, width), np.int64)
        sign = np.zeros((n_atoms, width))
        slot[atoms, rank] = cons
        sign[atoms, rank] = signs
        t = dict(device=device)
        tab = _Tables(i=torch.as_tensor(ij[:, 0], **t),
                      j=torch.as_tensor(ij[:, 1], **t),
                      r0=torch.as_tensor(np.asarray(self.r0, np.float64),
                                         dtype=dtype, **t),
                      slot=torch.as_tensor(slot, **t),
                      sign=torch.as_tensor(sign, dtype=dtype, **t))
        self._cache[key] = tab
        return tab

    @staticmethod
    def _cell(box, dtype):
        h = box.h.to(dtype)
        return h, cell_inverse(h)

    @staticmethod
    def _atom_sum(tab: _Tables, coef, corr):
        """[n, 3]: each atom's corrections, coef [n, D] (sign / mass, 0 on
        padding) times corr [m, 3] of its slots, summed over the slots in
        slot order."""
        return torch.sum(coef[:, :, None] * corr[tab.slot], dim=1)

    def _coef(self, tab: _Tables, masses):
        inv_m = 1.0 / masses
        return inv_m[tab.i], inv_m[tab.j], tab.sign * inv_m[:, None]

    def project_positions(self, pos_new, pos_old, vel, masses, box, dt):
        """SHAKE stage: move pos_new onto the constraint manifold along the
        pre-step bond directions; velocities get the consistent impulse."""
        if not self.pairs:
            return pos_new, vel
        tab = self.tables(pos_new.shape[0], pos_new.dtype, pos_new.device)
        inv_mi, inv_mj, coef = self._coef(tab, masses)
        cell = self._cell(box, pos_new.dtype)
        d_old = min_image(pos_old[tab.i] - pos_old[tab.j], *cell)
        r0sq = tab.r0 * tab.r0
        w = 2.0 * (inv_mi + inv_mj)
        pos = pos_new
        for _ in range(self.iters):
            d = min_image(pos[tab.i] - pos[tab.j], *cell)
            c = torch.sum(d * d, dim=1) - r0sq
            denom = w * torch.sum(d * d_old, dim=1)
            lam = c / torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)
            pos = pos + self._atom_sum(tab, coef, lam[:, None] * d_old)
        vel = vel + (pos - pos_new) / dt
        return pos, vel

    def project_velocities(self, pos, vel, masses, box):
        """RATTLE stage: remove bond-directional relative velocities."""
        if not self.pairs:
            return vel
        tab = self.tables(pos.shape[0], pos.dtype, pos.device)
        inv_mi, inv_mj, coef = self._coef(tab, masses)
        d = min_image(pos[tab.i] - pos[tab.j], *self._cell(box, pos.dtype))
        denom = (inv_mi + inv_mj) * torch.sum(d * d, dim=1)
        for _ in range(self.iters):
            vrel = torch.sum((vel[tab.i] - vel[tab.j]) * d, dim=1)
            vel = vel + self._atom_sum(tab, coef, (vrel / denom)[:, None] * d)
        return vel

    def max_violation(self, pos, box) -> torch.Tensor:
        """[] the largest |r - r0| over the constraints."""
        tab = self.tables(pos.shape[0], pos.dtype, pos.device)
        d = min_image(pos[tab.i] - pos[tab.j], *self._cell(box, pos.dtype))
        return torch.max(torch.abs(torch.linalg.norm(d, dim=1) - tab.r0))
