"""Neighbor displacements whose force backward gathers instead of
scattering: the mirror tables.

Port of lammps_ani_tpu/ops/nbr_grad.py, the single-device tables and,
for the sharded engine (parallel/), the extended-array form
(`build_mirror_ext`, `neighbor_diff_ext`). The force backward of a gathered
displacement `pos[i] - pos[src[i, k]]` is, under plain autograd, a
scatter-add of [n, k, 3] cotangents. With a full neighbor list every
directed slot (i -> owner j, image shift S) has exactly one mirror slot
(j -> owner i, shift -S), so the neighbor-role force on atom i is a
gather over i's own mirror slots:

    dE/dpos[i] = sum_k g[i, k]               (center role, row sum)
               - sum_k g.flat[mirror[i, k]]  (neighbor role, gather)

with g = dE/d diff. The box cotangent (the virial's path) is the exact
shift-weighted sum dE/dh = -sum shift^T g. The tables are built once per
rebuild (`build_mirror`); they need an untruncated neighbor matrix, which
the engine's overflow checks guarantee (`ok` reports a slot without its
mirror), built from a cutoff test that treats a pair and its mirror alike
(`neighbors.pair_displacements`: in f32 the JAX package's form keeps one
side of a pair at the cutoff now and then, from about 10^5 atoms on, and
its engine then regrows until it gives up).

The mirror form is the JAX package's workaround for a serialized TPU
scatter; the port keeps it because it holds the JAX contract (forces equal
to f64 rounding).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import neighbors as nbops

_NO_SHIFT_CODE = 13  # (0,0,0) in the 3x3x3 shift enumeration


@dataclasses.dataclass(frozen=True)
class MirrorNeighbors:
    """Owner-resolved neighbor structure with mirror-slot tables.

    Two channels, frozen between rebuilds: the full list [n, k], consumed
    as distances only (radial AEV and repulsion, `neighbor_dist`), and an
    angular sub-list [n, ka] of the slots within angular cutoff + skin,
    the only channel that needs displacement vectors, with its own mirror
    table."""

    src: torch.Tensor  # [n, k] int64 owner rows
    shift: torch.Tensor  # [n, k, 3] int64 image shifts
    mirror: torch.Tensor  # [n, k] int64 flat mirror slot indices
    mask: torch.Tensor  # [n, k] bool
    ok: torch.Tensor  # [] bool: every valid slot found its mirror
    species_j: Optional[torch.Tensor] = None  # [n, k]
    ang_src: Optional[torch.Tensor] = None  # [n, ka]
    ang_shift: Optional[torch.Tensor] = None  # [n, ka, 3]
    ang_mirror: Optional[torch.Tensor] = None  # [n, ka]
    ang_mask: Optional[torch.Tensor] = None  # [n, ka]
    ang_species: Optional[torch.Tensor] = None  # [n, ka]
    ang_count_max: Optional[torch.Tensor] = None  # [] overflow detection


def _subset_nlist(nlist, pos, box, n_local, cutoff, cap):
    """Compact the slots with current dist < cutoff into [n, cap], in slot
    order (a cumsum rank and one scatter; the JAX package's one-hot
    compaction gives the same table), the distance taken by the
    mirror-symmetric `neighbors.pair_displacements`. Returns (sub
    NeighborList, max count)."""
    n = nlist.idx.shape[0]
    d = nbops.pair_displacements(pos, box, nlist.ghosts,
                                 torch.arange(n, device=pos.device),
                                 nlist.idx)
    dist2 = torch.sum(d * d, dim=-1)
    keep = nlist.mask & (dist2 < cutoff * cutoff)
    count = keep.sum(dim=1)
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    sel = keep & (rank < cap)
    rows = torch.arange(n, device=pos.device)[:, None].expand_as(sel)
    idx_a = torch.zeros((n, cap), dtype=nlist.idx.dtype, device=pos.device)
    mask_a = torch.zeros((n, cap), dtype=torch.bool, device=pos.device)
    idx_a[rows[sel], rank[sel]] = nlist.idx[sel]
    mask_a[rows[sel], rank[sel]] = True
    cnt = count.max()
    sub = nbops.NeighborList(idx=idx_a, mask=mask_a, ghosts=nlist.ghosts,
                             max_count=cnt)
    return sub, cnt


def mirror_neighbors(nlist, n_local: int, chunk: int = 2048, pos=None,
                     box=None, ang_cutoff: float | None = None,
                     ang_cap: int | None = None, species=None,
                     main_mirror: bool = True) -> MirrorNeighbors:
    """Resolve a NeighborList into the owner/shift/mirror form.

    With (pos, box, ang_cutoff, ang_cap) also builds the angular
    sub-channel (slots within ang_cutoff now; size the cutoff with the
    skin so the frozen subset stays complete until the next rebuild).
    With `species`, the per-slot neighbor species are gathered here once.
    `main_mirror=False` (the radial channel is served by the cell-roll
    path) leaves the full list's mirror table zero."""
    src, shift = resolve_owners(nlist, n_local)
    if main_mirror:
        mirror, ok = build_mirror(nlist, n_local, chunk=chunk)
    else:
        mirror = torch.zeros_like(nlist.idx)
        ok = torch.ones((), dtype=torch.bool, device=src.device)
    ang = {}
    if species is not None:
        ang["species_j"] = torch.where(nlist.mask, species[src], -1)
    if ang_cutoff is not None:
        sub, cnt = _subset_nlist(nlist, pos, box, n_local, ang_cutoff,
                                 ang_cap)
        a_src, a_shift = resolve_owners(sub, n_local)
        a_mirror, a_ok = build_mirror(sub, n_local, chunk=chunk)
        ok = ok & a_ok & (cnt <= ang_cap)
        ang.update(ang_src=a_src, ang_shift=a_shift, ang_mirror=a_mirror,
                   ang_mask=sub.mask, ang_count_max=cnt)
        if species is not None:
            ang["ang_species"] = torch.where(sub.mask, species[a_src], -1)
    return MirrorNeighbors(src=src, shift=shift, mirror=mirror,
                           mask=nlist.mask, ok=ok, **ang)


def shift_code(shift: torch.Tensor) -> torch.Tensor:
    """[..., 3] int shift in {-1,0,1} -> [...] code in [0, 27)."""
    s = shift + 1
    return (s[..., 0] * 3 + s[..., 1]) * 3 + s[..., 2]


def resolve_owners(nlist, n_local: int):
    """(src [n,k] owner rows, shift [n,k,3]) of a NeighborList over
    [local; ghosts]."""
    ghosts = nlist.ghosts
    dev = nlist.idx.device
    ext_src = torch.cat([torch.arange(n_local, device=dev),
                         ghosts.src.to(torch.int64)])
    ext_shift = torch.cat([torch.zeros((n_local, 3), dtype=torch.int64,
                                       device=dev),
                           ghosts.shift.to(torch.int64)])
    return ext_src[nlist.idx], ext_shift[nlist.idx]


def build_mirror(nlist, n_local: int, chunk: int = 2048):
    """([n, k] flat index of each slot's mirror slot, ok flag).

    mirror[i, k] = j * k_max + k' where idx[j, k'] is the local or ghost
    copy of i with the opposite image shift (the first such slot). Dense
    compares over row chunks, no sort."""
    idx, mask = nlist.idx, nlist.mask
    n, k_max = idx.shape
    ghosts = nlist.ghosts
    dev = idx.device
    g_cap = ghosts.src.shape[0]
    # ext id of (owner, shift code): locals at code 13, valid ghosts at
    # theirs
    lookup = torch.full((n_local, 27), -1, dtype=torch.int64, device=dev)
    lookup[:, _NO_SHIFT_CODE] = torch.arange(n_local, device=dev)
    gv = ghosts.mask
    lookup[ghosts.src[gv].to(torch.int64),
           shift_code(ghosts.shift[gv].to(torch.int64))] = (
        n_local + torch.arange(g_cap, device=dev)[gv])
    src, shift = resolve_owners(nlist, n_local)
    inv_code = shift_code(-shift)
    mirror = torch.zeros_like(idx)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        rows = torch.arange(r0, r1, device=dev)
        # target ext id: the copy of the row atom with the opposite shift
        tgt = lookup[rows[:, None], inv_code[r0:r1]]
        src_c, mask_c = src[r0:r1], mask[r0:r1]
        hit = idx[src_c] == tgt[..., None]  # [c, k, k_max]
        kprime = torch.argmax(hit.to(torch.uint8), dim=-1)
        found = hit.any(dim=-1) & (tgt >= 0)
        ok = ok & torch.all(found | ~mask_c)
        mirror[r0:r1] = torch.where(mask_c, src_c * k_max + kprime, 0)
    return mirror, ok


def _shift_pos(pos, h, src, shift_f):
    return pos[src] + shift_f @ h


class _NeighborDiff(torch.autograd.Function):
    """[n, k, 3] diff = pos_i - (pos[src] + shift @ h), masked slots 1.0;
    backward: row sum minus the mirror gather, and the box cotangent."""

    @staticmethod
    def forward(ctx, pos, h, src, shift_f, mirror, mask):
        ctx.save_for_backward(shift_f, mirror, mask)
        diff = pos[:, None, :] - _shift_pos(pos, h, src, shift_f)
        return torch.where(mask[..., None], diff, 1.0)

    @staticmethod
    def backward(ctx, g):
        shift_f, mirror, mask = ctx.saved_tensors
        n, k_max, _ = g.shape
        g = torch.where(mask[..., None], g, 0.0)
        # invalid slots carry mirror index 0: mask the gathered rows too
        mirrored = g.reshape(n * k_max, 3)[mirror] * mask[..., None]
        dpos = g.sum(dim=1) - mirrored.sum(dim=1)
        dh = -torch.einsum("nka,nkb->ab", shift_f, g)
        return dpos, dh, None, None, None, None


class _NeighborDist(torch.autograd.Function):
    """[n, k] distances, masked slots 1e6; the backward moves one scalar
    per slot: by the mirror symmetry unit_{j,k'} = -unit_{i,k}, so
    dpos[i] = sum_k (g[i,k] + g.flat[mirror[i,k]]) unit[i,k] and
    dh = -sum shift^T (g unit) over each slot's own row."""

    @staticmethod
    def forward(ctx, pos, h, src, shift_f, mirror, mask):
        ctx.save_for_backward(pos, h, src, shift_f, mirror, mask)
        diff = pos[:, None, :] - _shift_pos(pos, h, src, shift_f)
        d = torch.linalg.norm(torch.where(mask[..., None], diff, 1.0),
                              dim=-1)
        return torch.where(mask, d, 1e6)

    @staticmethod
    def backward(ctx, g):
        pos, h, src, shift_f, mirror, mask = ctx.saved_tensors
        n, k_max = g.shape
        g = torch.where(mask, g, 0.0)
        # the unit vectors are recomputed, not kept from the forward
        diff = pos[:, None, :] - _shift_pos(pos, h, src, shift_f)
        d = torch.linalg.norm(torch.where(mask[..., None], diff, 1.0),
                              dim=-1)
        unit = torch.where(mask[..., None], diff / d[..., None], 0.0)
        gm = g.reshape(n * k_max)[mirror] * mask
        dpos = torch.sum((g + gm)[..., None] * unit, dim=1)
        dh = -torch.einsum("nka,nk,nkb->ab", shift_f, g, unit)
        return dpos, dh, None, None, None, None


def neighbor_diff(pos, h, src, shift_f, mirror, mask):
    """[n, k, 3] pos_i - (pos[src] + shift @ h) with the mirror backward."""
    return _NeighborDiff.apply(pos, h, src, shift_f, mirror, mask)


def neighbor_dist(pos, h, src, shift_f, mirror, mask):
    """[n, k] distances with the scalar-cotangent mirror backward."""
    return _NeighborDist.apply(pos, h, src, shift_f, mirror, mask)


def neighbor_displacements_mirror(pos, box, src, shift, mirror, mask):
    """(diff [n,k,3], dist [n,k]) with the mirror backward: the same
    orientation and masking as neighbors.neighbor_displacements."""
    shift_f = shift.to(pos.dtype)
    diff = neighbor_diff(pos, box.h, src, shift_f, mirror, mask)
    dist = torch.linalg.norm(diff, dim=-1)
    return (torch.where(mask[..., None], diff, 1.0),
            torch.where(mask, dist, 1e6))


# ---------------------------------------------------------------------------
# Extended-array form (the sharded engine): ghosts are halo imports
# ---------------------------------------------------------------------------


def build_mirror_ext(idx, mask, ext_idx, ext_mask):
    """Mirror table of the extended-array neighbor form (parallel/).

    There ghosts are halo copies of atoms of other shards, not periodic
    images of locals, so `build_mirror`'s owner/shift symmetry does not
    apply. The one that does: every directed slot (local i -> ext a) has
    its transpose in a's own row over the local candidates (`ext_idx`),
    since both take the same distance up to an exact negation. So

        mirror[a, q] = i * k_max + k'  with  i = ext_idx[a, q],
                                             idx[i, k'] = a,

    and the neighbor-role force on ext row a is a gather over a's own row;
    the ghost rows' part reaches the owners through the halo's backward.
    The pairs (a, i) of the valid slots of `idx` are sorted once and each
    ext slot's pair is looked up in them (a row of `idx` holds a neighbor
    once, so a pair has one slot), not compared against whole rows.

    Returns (mirror [m, k2] int64 flat into n * k_max, mvalid [m, k2],
    ok): `ok` is False if a valid ext slot found no transposed entry (an
    untruncated `idx` never lets that happen)."""
    n, k_max = idx.shape
    m, k2 = ext_idx.shape
    dev = idx.device
    rows = torch.arange(n, device=dev)[:, None]
    keys, slot_of = torch.sort(torch.where(mask, idx * n + rows, -1)
                               .reshape(-1))
    want = (torch.arange(m, device=dev)[:, None] * n + ext_idx).reshape(-1)
    at = torch.clamp(torch.searchsorted(keys, want), max=keys.shape[0] - 1)
    found = (keys[at] == want).reshape(m, k2)
    mvalid = ext_mask & found
    mirror = torch.where(mvalid, slot_of[at].reshape(m, k2), 0)
    return mirror, mvalid, torch.all(found | ~ext_mask)


class _NeighborDiffExt(torch.autograd.Function):
    """[n, k, 3] diff = pos_i - pos_ext[idx], masked slots 1.0; backward:
    the row sum (center role) and, for `pos_ext`, the gather over each ext
    row's mirror slots (neighbor role) instead of a scatter."""

    @staticmethod
    def forward(ctx, pos, pos_ext, idx, mask, mirror, mvalid):
        ctx.save_for_backward(mask, mirror, mvalid)
        diff = pos[:, None, :] - pos_ext[idx]
        return torch.where(mask[..., None], diff, 1.0)

    @staticmethod
    def backward(ctx, g):
        mask, mirror, mvalid = ctx.saved_tensors
        n, k_max, _ = g.shape
        g = torch.where(mask[..., None], g, 0.0)
        dpos = g.sum(dim=1)
        mirrored = g.reshape(n * k_max, 3)[mirror] * mvalid[..., None]
        return dpos, -mirrored.sum(dim=1), None, None, None, None


def neighbor_diff_ext(pos, pos_ext, idx, mask, mirror, mvalid):
    """[n, k, 3] pos_i - pos_ext[idx] (masked slots 1.0) with the mirror
    backward of `build_mirror_ext`'s tables. The caller's construction of
    `pos_ext` (parallel/domain.halo_positions) carries the ghost rows'
    cotangents to their owners."""
    return _NeighborDiffExt.apply(pos, pos_ext, idx, mask, mirror, mvalid)
