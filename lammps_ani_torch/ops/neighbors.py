"""Periodic boundary conditions, ghost images and neighbor matrices.

Port of lammps_ani_tpu/ops/neighbors.py. The neighbor matrix is the
mirror engine's neighbor structure (with ops/nbr_grad.py) and the degree
measure that sizes every engine's capacities
(md/simulation.Simulation._derive_angular_caps); the asn and roll engines
step over the bin grid of ops/cell_roll.py instead. Pairs are selected by
`pair_displacements`, which rounds a pair and its mirror alike.

Box convention: LAMMPS triclinic. `h` is the 3x3 row-vector cell matrix
[[lx,0,0],[xy,ly,0],[xz,yz,lz]]; cartesian = origin + frac @ h.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Box:
    """Triclinic simulation cell. `h`: [3,3] row-vector cell matrix."""

    h: torch.Tensor
    origin: torch.Tensor

    @staticmethod
    def orthorhombic(lengths, origin=(0.0, 0.0, 0.0), dtype=torch.float32,
                     device=None) -> "Box":
        """A rectangular box of edge `lengths` at `origin`, on the card
        unless `device` says otherwise."""
        dev = resolve_device(device)
        return Box(h=torch.diag(torch.as_tensor(lengths, dtype=dtype,
                                                device=dev)),
                   origin=torch.as_tensor(origin, dtype=dtype, device=dev))

    @staticmethod
    def from_lammps(xlo, xhi, ylo, yhi, zlo, zhi, xy=0.0, xz=0.0, yz=0.0,
                    dtype=torch.float32, device=None) -> "Box":
        """The box of a LAMMPS data file's bounds and tilt factors, on the
        card unless `device` says otherwise."""
        h = torch.tensor([[xhi - xlo, 0.0, 0.0], [xy, yhi - ylo, 0.0],
                          [xz, yz, zhi - zlo]], dtype=dtype,
                         device=resolve_device(device))
        return Box(h=h, origin=torch.tensor([xlo, ylo, zlo], dtype=dtype,
                                            device=h.device))

    def to(self, device=None, dtype=None) -> "Box":
        return Box(h=self.h.to(device=device, dtype=dtype),
                   origin=self.origin.to(device=device, dtype=dtype))

    @property
    def volume(self) -> torch.Tensor:
        return self.h[0, 0] * self.h[1, 1] * self.h[2, 2]

    def perp_lengths(self) -> torch.Tensor:
        """[3] distances between opposite cell faces."""
        a, b, c = self.h[0], self.h[1], self.h[2]
        v = torch.abs(torch.dot(a, torch.linalg.cross(b, c)))
        return torch.stack([
            v / torch.linalg.norm(torch.linalg.cross(b, c)),
            v / torch.linalg.norm(torch.linalg.cross(c, a)),
            v / torch.linalg.norm(torch.linalg.cross(a, b)),
        ])

    def to_fractional(self, pos: torch.Tensor) -> torch.Tensor:
        """Cartesian [n,3] -> fractional [n,3] by back-substitution."""
        r = pos - self.origin
        f2 = r[..., 2] / self.h[2, 2]
        f1 = (r[..., 1] - f2 * self.h[2, 1]) / self.h[1, 1]
        f0 = (r[..., 0] - f1 * self.h[1, 0] - f2 * self.h[2, 0]) / self.h[0, 0]
        return torch.stack([f0, f1, f2], dim=-1)

    def from_fractional(self, frac: torch.Tensor) -> torch.Tensor:
        return self.origin + frac @ self.h


def cell_inverse(h: torch.Tensor) -> torch.Tensor:
    """inv(h) of a [3, 3] cell matrix by its adjugate (rows a, b, c: the
    columns b x c, c x a, a x b over a . (b x c)): elementwise operations
    only, so on the card no solver call and no read back to the host."""
    a, b, c = h[0], h[1], h[2]
    bc = torch.linalg.cross(b, c)
    adj = torch.stack([bc, torch.linalg.cross(c, a),
                       torch.linalg.cross(a, b)], dim=1)
    return adj / torch.dot(a, bc)


def min_image(d: torch.Tensor, h: torch.Tensor,
              hinv: torch.Tensor) -> torch.Tensor:
    """Minimum-image difference vectors [..., 3]: (frac - round(frac)) @ h
    with frac = d @ hinv."""
    frac = d @ hinv
    return (frac - torch.round(frac)) @ h


def wrap_positions(pos: torch.Tensor, box: Box) -> torch.Tensor:
    """Remap atoms into the primary cell (LAMMPS PBC remap at reneighbor)."""
    frac = box.to_fractional(pos)
    return box.from_fractional(frac - torch.floor(frac))


def image_shifts(n_shell: int | Sequence[int],
                 periodic=(True, True, True)) -> np.ndarray:
    """Static integer image shifts (excluding (0,0,0)), shape [n_shifts, 3]."""
    if isinstance(n_shell, int):
        n_shell = (n_shell, n_shell, n_shell)
    ranges = [range(-n, n + 1) if p else range(0, 1)
              for n, p in zip(n_shell, periodic)]
    shifts = [(i, j, k) for i in ranges[0] for j in ranges[1]
              for k in ranges[2] if (i, j, k) != (0, 0, 0)]
    return (np.asarray(shifts, np.int32) if shifts
            else np.zeros((0, 3), np.int32))


@dataclasses.dataclass(frozen=True)
class Ghosts:
    """Derived periodic-image atoms (fixed capacity)."""

    src: torch.Tensor  # [g] int64 owner index (0 for padding slots)
    shift: torch.Tensor  # [g, 3] int64 integer image shift
    mask: torch.Tensor  # [g] bool
    count: torch.Tensor  # [] int64 true number of ghosts (overflow if > g)


def build_ghosts(pos: torch.Tensor, box: Box, cutoff: float, capacity: int,
                 shifts: np.ndarray) -> Ghosts:
    """Enumerate periodic images within `cutoff` of the primary cell, in
    (atom, shift) row-major order."""
    n = pos.shape[0]
    dev = pos.device
    m = shifts.shape[0]
    if m == 0:
        z = torch.zeros((capacity,), dtype=torch.int64, device=dev)
        return Ghosts(src=z, shift=torch.zeros((capacity, 3), dtype=torch.int64,
                                               device=dev),
                      mask=torch.zeros((capacity,), dtype=torch.bool,
                                       device=dev),
                      count=torch.zeros((), dtype=torch.int64, device=dev))
    frac = box.to_fractional(pos)
    margin = cutoff / box.perp_lengths()
    s = torch.as_tensor(shifts, dtype=frac.dtype, device=dev)
    cand = frac[:, None, :] + s[None, :, :]
    keep = torch.all((cand > -margin) & (cand < 1.0 + margin), dim=-1)
    flat = keep.reshape(-1)
    count = flat.sum()
    idx = torch.nonzero(flat).reshape(-1)[:capacity]
    fill = torch.full((capacity - idx.shape[0],), n * m, dtype=idx.dtype,
                      device=dev)
    idx = torch.cat([idx, fill])
    valid = idx < n * m
    src = torch.where(valid, idx // m, 0)
    shift = torch.where(valid[:, None],
                        torch.as_tensor(shifts, dtype=torch.int64,
                                        device=dev)[idx % m], 0)
    return Ghosts(src=src, shift=shift, mask=valid, count=count)


def ghost_positions(pos: torch.Tensor, box: Box, ghosts: Ghosts) -> torch.Tensor:
    """[g, 3] ghost cartesian positions, differentiable w.r.t. `pos`."""
    g = pos[ghosts.src] + ghosts.shift.to(pos.dtype) @ box.h
    far = box.origin + 1e6
    return torch.where(ghosts.mask[:, None], g, far)


def extended_positions(pos: torch.Tensor, box: Box, ghosts: Ghosts):
    """[n + g, 3]: local atoms followed by ghost images."""
    return torch.cat([pos, ghost_positions(pos, box, ghosts)], dim=0)


def pair_displacements(pos: torch.Tensor, box: Box, ghosts: Ghosts,
                       rows: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """[r, c, 3] pos[rows] - [pos; ghosts][cand], for neighbor selection,
    as (pos_i - pos_owner) - S h: a pair and its mirror (the owner's row
    and the copy of i with shift -S) round to exact negatives, so a cutoff
    test selects both or neither. pos_i - (pos_owner + S h), the JAX
    package's form, rounds the ghost first and can keep one side of a
    pair at the cutoff in f32, leaving a slot without its mirror
    (ops/nbr_grad.build_mirror). S h is summed elementwise in a fixed
    order, so -S gives exactly -S h. Padding ghosts are not parked here:
    mask them by `ghosts.mask`."""
    n = pos.shape[0]
    dev = pos.device
    ext_src = torch.cat([torch.arange(n, device=dev),
                         ghosts.src.to(torch.int64)])
    sf = torch.cat([torch.zeros((n, 3), dtype=torch.int64, device=dev),
                    ghosts.shift.to(torch.int64)]).to(pos.dtype)
    h = box.h
    shift_h = sf[:, 0:1] * h[0] + sf[:, 1:2] * h[1] + sf[:, 2:3] * h[2]
    return (pos[rows][:, None, :] - pos[ext_src[cand]]) - shift_h[cand]


def extended_species(species: torch.Tensor, ghosts: Ghosts) -> torch.Tensor:
    """[n + g] species; padding ghost slots = -1."""
    gs = torch.where(ghosts.mask, species[ghosts.src], -1)
    return torch.cat([species, gs.to(species.dtype)], dim=0)


@dataclasses.dataclass(frozen=True)
class NeighborList:
    """Padded full neighbor matrix over local+ghost atoms."""

    idx: torch.Tensor  # [n, k_max] int64 into [pos; ghost positions]
    mask: torch.Tensor  # [n, k_max] bool
    ghosts: Ghosts
    max_count: torch.Tensor  # [] true max row degree

    @property
    def overflowed(self):
        return ((self.max_count > self.idx.shape[1])
                | (self.ghosts.count > self.ghosts.src.shape[0]))


def _closest_k(key: torch.Tensor, k_max: int):
    """Closest-first top-k over rows of `key` (+inf = masked), padded to
    k_max: (neg_key [r, k_max], sel [r, k_max])."""
    k_eff = min(k_max, key.shape[1])
    neg_key, sel = torch.topk(-key, k_eff, dim=1)
    if k_eff < k_max:
        pad = k_max - k_eff
        neg_key = torch.nn.functional.pad(neg_key, (0, pad),
                                          value=-float("inf"))
        sel = torch.nn.functional.pad(sel, (0, pad))
    return neg_key, sel


def build_neighbor_matrix_brute(pos: torch.Tensor, box: Box, cutoff: float,
                                k_max: int, ghosts: Ghosts) -> NeighborList:
    """O(n * (n+g)) dense build — simple and exact; for small systems.
    Pairs are selected by `pair_displacements` (mirror-symmetric)."""
    n = pos.shape[0]
    m = n + ghosts.src.shape[0]
    ar_m = torch.arange(m, device=pos.device)
    rows = torch.arange(n, device=pos.device)
    d = pair_displacements(pos, box, ghosts, rows, ar_m[None, :].expand(n, m))
    dist2 = torch.sum(d * d, dim=-1)
    within = dist2 < cutoff ** 2
    not_self = rows[:, None] != ar_m[None, :]
    ext_valid = torch.cat([torch.ones((n,), dtype=torch.bool,
                                      device=pos.device), ghosts.mask])
    mask = within & not_self & ext_valid[None, :]
    counts = mask.sum(dim=1)
    key = torch.where(mask, dist2, float("inf"))
    neg_key, idx = _closest_k(key, k_max)
    nbr_mask = torch.isfinite(neg_key)
    idx = torch.where(nbr_mask, idx, 0)
    return NeighborList(idx=idx, mask=nbr_mask, ghosts=ghosts,
                        max_count=counts.max())


def neighbor_displacements(pos: torch.Tensor, box: Box, nlist: NeighborList):
    """(diff [n,k,3], dist [n,k]); diff[i,k] = r_i - r_j. Masked slots get
    distance 1e6."""
    pos_ext = extended_positions(pos, box, nlist.ghosts)
    diff = pos[:, None, :] - pos_ext[nlist.idx]
    safe = torch.where(nlist.mask[..., None], diff, 1.0)
    dist = torch.linalg.norm(safe, dim=-1)
    dist = torch.where(nlist.mask, dist, 1e6)
    return diff, dist


def estimate_k_max(density_per_a3: float, cutoff: float,
                   safety: float = 1.35) -> int:
    """Host-side capacity heuristic: the atoms within a cutoff sphere at
    `density_per_a3`, times `safety`, rounded up to a multiple of 8."""
    vol = 4.0 / 3.0 * np.pi * cutoff ** 3
    return int(np.ceil(density_per_a3 * vol * safety / 8.0) * 8)
