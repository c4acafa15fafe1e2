"""Spatial domain decomposition over a mesh of shards.

Port of lammps_ani_tpu/parallel/domain.py (LAMMPS 3-D brick decomposition
and its staged ghost exchange) over either mesh of `comm.py`: a per-shard
tensor is [n_local, ...], the process's shards in row-major mesh order
(every shard on `LocalMesh`, one a rank on `ProcessGroupMesh`), and a
ppermute is `mesh.shift`.

  * The box is cut into a (px, py, pz) grid of equal fractional bricks.
    Each shard holds `n_cap` fixed atom slots; an empty slot carries
    species -1, so every shape is static.
  * Halo exchange is the LAMMPS 6-way staged protocol: stage x sends the
    atoms within the halo margin of a face to the x-neighbor on that side,
    stage y sources the locals and the x-ghosts, stage z all of it, so
    corner ghosts arrive exactly once. On an axis of size 1 the exchange
    is the shard's own periodic image.
  * There is no reverse force communication: ghost positions are
    recomputed from their owners inside the differentiated energy
    (`halo_positions`), and autograd carries each ghost's force back to
    its owner through the inverse shifts. The gather that picks the rows
    to send has a gather as its backward (over the stage's inverse map:
    a row is sent at most once per stage), so no float scatter runs.
  * Atoms migrate between bricks at rebuilds, staged per axis like LAMMPS
    `Comm::exchange`; capacities are static and each overflow is reported
    per shard for the host to grow.

Geometry contract: every brick extent must be at least rlist, so halos
come only from adjacent bricks (checked by `DomainSimulation`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import cell_roll as crmod
from ..ops import neighbors as nbops

AXIS_NAMES = ("dx", "dy", "dz")
_FAR = 1.0e6  # parking position of empty ghost slots
# rows of a brute or brick neighbor build taken at once
_ROW_CHUNK = 4096
_OFFSETS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
            for k in (-1, 0, 1)]


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    """Static decomposition geometry and capacities."""

    mesh_shape: tuple[int, int, int]
    n_cap: int  # owned-atom slots per shard
    halo_cap: tuple[int, int, int]  # ghost slots per direction, per axis
    mig_cap: int = 256  # migration slots per direction per axis
    k_max: int = 160  # neighbor slots per atom

    @property
    def n_shards(self) -> int:
        px, py, pz = self.mesh_shape
        return px * py * pz

    @property
    def n_ext(self) -> int:
        return self.n_cap + 2 * sum(self.halo_cap)


def perp_lengths(box_h) -> np.ndarray:
    """[3] distances between opposite faces of the cell `box_h`."""
    h = np.asarray(box_h, np.float64)
    v = abs(np.dot(h[0], np.cross(h[1], h[2])))
    return np.array([v / np.linalg.norm(np.cross(h[1], h[2])),
                     v / np.linalg.norm(np.cross(h[2], h[0])),
                     v / np.linalg.norm(np.cross(h[0], h[1]))])


def _pack(mask: torch.Tensor, cap: int):
    """Fixed-capacity compaction of [..., n] `mask`: (idx [..., cap] of the
    True entries in ascending order, n - 1 past them; valid [..., cap];
    count [...]). A stable sort, so the order is `jnp.nonzero`'s and
    nothing is read back to the host."""
    n = mask.shape[-1]
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    if cap <= n:
        order = order[..., :cap]
    else:
        order = torch.nn.functional.pad(order, (0, cap - n), value=n - 1)
    count = mask.sum(dim=-1)
    valid = (torch.arange(cap, device=mask.device) < count[..., None])
    return torch.where(valid, order, n - 1), valid, count


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [S, n, ...] at idx [S, c] -> [S, c, ...]."""
    s = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[s, idx]


def _bshape(mask, arr):
    """Broadcast an [S, n] mask against an [S, n, ...] tensor."""
    return mask.reshape(mask.shape + (1,) * (arr.ndim - mask.ndim))


def _lo(mesh, dtype) -> torch.Tensor:
    """[S, 3] each brick's fractional origin."""
    shape = torch.as_tensor(mesh.mesh_shape, device=mesh.device)
    return mesh.coords().to(dtype) / shape.to(dtype)


# ---------------------------------------------------------------------------
# Halo plan: built at a rebuild, frozen until the next
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HaloStage:
    """One (axis, direction) exchange of every shard: what it sends and the
    metadata of what it receives (species and validity hold between
    rebuilds)."""

    send_idx: torch.Tensor  # [S, cap] rows of the ext-so-far array
    send_valid: torch.Tensor  # [S, cap]
    send_shift: torch.Tensor  # [S] +-1 / 0: lattice shift along the axis
    recv_valid: torch.Tensor  # [S, cap]
    recv_species: torch.Tensor  # [S, cap]
    send_inv: torch.Tensor  # [S, n_src] slot a row is sent in, cap if none


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    stages: list  # 6 HaloStage: (x -> right, x -> left, y -> right, ...)
    overflow: torch.Tensor  # [S] bool

    def ext_species(self, species_local: torch.Tensor) -> torch.Tensor:
        parts = [species_local]
        for st in self.stages:
            parts.append(torch.where(st.recv_valid, st.recv_species, -1))
        return torch.cat(parts, dim=1)

    def ext_valid(self, valid_local: torch.Tensor) -> torch.Tensor:
        return torch.cat([valid_local] + [st.recv_valid
                                          for st in self.stages], dim=1)


class _SendRows(torch.autograd.Function):
    """[S, n, 3] -> [S, cap, 3] rows `idx`; the backward gathers each row's
    cotangent through the inverse map `inv` (a row is sent at most once),
    so it is exact and in a fixed order on every device."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _rows(src, idx)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        g_pad = torch.nn.functional.pad(g, (0, 0, 0, 1))  # row cap is zero
        return _rows(g_pad, inv), None, None


def _inverse(send_idx, send_valid, n_src):
    """[S, n_src]: the send slot of each source row, cap where it is not
    sent."""
    s, cap = send_idx.shape
    inv = torch.full((s, n_src + 1), cap, dtype=torch.int64,
                     device=send_idx.device)
    slots = torch.arange(cap, device=send_idx.device).expand(s, cap)
    inv.scatter_(1, torch.where(send_valid, send_idx, n_src), slots)
    return inv[:, :n_src]


def build_halo_plan(mesh, spec: DomainSpec, pos: torch.Tensor,
                    species: torch.Tensor, valid: torch.Tensor,
                    box: nbops.Box, rlist: float) -> HaloPlan:
    """The 6-stage exchange plan of every shard from its wrapped owned
    positions `pos` [S, n_cap, 3], `species` and `valid` [S, n_cap].

    Both directions of an axis source from the set accumulated over the
    previous axes (locals and earlier-axis ghosts); ghosts received along
    an axis are never sent again along it (the LAMMPS staging invariant
    that makes corner ghosts appear exactly once)."""
    dtype = pos.dtype
    perp = box.perp_lengths()
    stages = []
    ext_pos, ext_species, ext_valid = pos, species, valid
    overflow = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
    for axis in range(3):
        p = spec.mesh_shape[axis]
        cap = spec.halo_cap[axis]
        me = mesh.axis_index(axis)
        margin = (torch.tensor(rlist, dtype=dtype, device=pos.device)
                  / perp[axis])
        lo = me.to(dtype) / p
        hi = (me.to(dtype) + 1.0) / p
        # the frozen source set of this axis (both directions)
        src_pos, src_species, src_valid = ext_pos, ext_species, ext_valid
        frac = box.to_fractional(src_pos)[..., axis]
        for direction in (+1, -1):
            if direction == +1:  # the top margin to the right neighbor
                send_mask = src_valid & (frac >= (hi - margin)[:, None])
                shift = torch.where(me == p - 1, -1.0, 0.0).to(dtype)
            else:  # the bottom margin to the left neighbor
                send_mask = src_valid & (frac < (lo + margin)[:, None])
                shift = torch.where(me == 0, 1.0, 0.0).to(dtype)
            send_idx, send_valid, count = _pack(send_mask, cap)
            overflow = overflow | (count > cap)
            recv_valid = mesh.shift(send_valid, axis, direction)
            recv_species = mesh.shift(
                torch.where(send_valid, _rows(src_species, send_idx), -1),
                axis, direction)
            st = HaloStage(send_idx=send_idx, send_valid=send_valid,
                           send_shift=shift, recv_valid=recv_valid,
                           recv_species=recv_species,
                           send_inv=_inverse(send_idx, send_valid,
                                             src_pos.shape[1]))
            stages.append(st)
            # received ghosts join the source set of the NEXT axis
            g = halo_stage_positions(mesh, src_pos, box, st, axis, direction)
            ext_pos = torch.cat([ext_pos, g], dim=1)
            ext_species = torch.cat(
                [ext_species, torch.where(recv_valid, recv_species, -1)],
                dim=1)
            ext_valid = torch.cat([ext_valid, recv_valid], dim=1)
    return HaloPlan(stages=stages, overflow=overflow)


def halo_stage_positions(mesh, src_pos, box, stage: HaloStage, axis: int,
                         direction: int) -> torch.Tensor:
    """[S, cap, 3] ghost positions received in one stage
    (differentiable)."""
    p = _SendRows.apply(src_pos, stage.send_idx, stage.send_inv)
    p = torch.where(stage.send_valid[..., None], p, _FAR)
    p = p + stage.send_shift[:, None, None] * box.h[axis]
    p = mesh.shift(p, axis, direction)
    return torch.where(stage.recv_valid[..., None], p, _FAR)


def halo_positions(mesh, spec: DomainSpec, pos: torch.Tensor,
                   box: nbops.Box, plan: HaloPlan) -> torch.Tensor:
    """[S, n_ext, 3] extended positions from the owned positions.

    Run every step inside the differentiated energy (the forward position
    exchange); its backward is the reverse force exchange. The stage order
    is build_halo_plan's."""
    ext = pos
    si = 0
    for axis in range(3):
        cur = ext  # both directions of an axis source from the same set
        for direction in (+1, -1):
            g = halo_stage_positions(mesh, cur, box, plan.stages[si], axis,
                                     direction)
            ext = torch.cat([ext, g], dim=1)
            si += 1
    return ext


# ---------------------------------------------------------------------------
# Atom migration (at a rebuild, staged per sharded axis)
# ---------------------------------------------------------------------------


def migrate(mesh, spec: DomainSpec, payload: dict, valid: torch.Tensor,
            box: nbops.Box):
    """Move the atoms whose wrapped position left their brick to the
    neighbor shard that owns it. `payload`: [S, n_cap, ...] tensors, "pos"
    among them. Returns (payload, valid, overflow [S]): an overflow is a
    direction over `mig_cap`, a shard over `n_cap`, or an atom more than
    one brick away (a stray hop)."""
    overflow = torch.zeros(valid.shape[0], dtype=torch.bool,
                           device=valid.device)
    for axis in range(3):
        p = spec.mesh_shape[axis]
        if p == 1:
            continue
        me = mesh.axis_index(axis)[:, None]
        frac = box.to_fractional(payload["pos"])[..., axis]
        target = torch.clamp(torch.floor(frac * p).to(torch.int64), 0, p - 1)
        go_right = valid & (target == (me + 1) % p)
        go_left = valid & (target == (me - 1) % p)
        if p == 2:  # the right and left neighbor coincide: one way only
            go_left = go_left & ~go_right
        stray = valid & (target != me) & ~go_right & ~go_left
        overflow = overflow | stray.any(dim=1)
        stay = valid & ~go_right & ~go_left

        parts = {k: [torch.where(_bshape(stay, v), v, 0)]
                 for k, v in payload.items()}
        valid_parts = [stay]
        for direction, mask in ((+1, go_right), (-1, go_left)):
            idx, pk_valid, count = _pack(mask, spec.mig_cap)
            overflow = overflow | (count > spec.mig_cap)
            valid_parts.append(mesh.shift(pk_valid, axis, direction))
            for k, v in payload.items():
                taken = _rows(v, idx)
                sent = torch.where(_bshape(pk_valid, taken), taken, 0)
                parts[k].append(mesh.shift(sent, axis, direction))

        comb_valid = torch.cat(valid_parts, dim=1)
        overflow = overflow | (comb_valid.sum(dim=1) > spec.n_cap)
        order = torch.argsort((~comb_valid).to(torch.uint8), dim=1,
                              stable=True)[:, :spec.n_cap]
        valid = _rows(comb_valid, order)
        payload = {k: _rows(torch.cat(parts[k], dim=1), order)
                   for k in payload}
    # the packing's fill values (0) would alias species / gid 0
    payload = dict(payload)
    payload["species"] = torch.where(valid, payload["species"], -1)
    if "gid" in payload:
        payload["gid"] = torch.where(valid, payload["gid"], -1)
    if "mass" in payload:
        payload["mass"] = torch.where(valid, payload["mass"], 1.0)
    center = box.origin + 0.5 * torch.sum(box.h, dim=0)
    payload["pos"] = torch.where(valid[..., None], payload["pos"], center)
    return payload, valid, overflow


# ---------------------------------------------------------------------------
# Per-shard neighbor matrix over the extended arrays
# ---------------------------------------------------------------------------


def _rows_topk(mask, dist2, k, gather_from=None):
    """Closest-first slot selection: (idx, mask, max count)."""
    counts = mask.sum(dim=1)
    key = torch.where(mask, dist2, float("inf"))
    neg_key, sel = nbops._closest_k(key, k)
    out_mask = torch.isfinite(neg_key)
    if gather_from is not None:
        sel = torch.gather(gather_from, 1,
                           torch.clamp(sel, max=gather_from.shape[1] - 1))
    idx = torch.where(out_mask, sel, 0)
    return idx, out_mask, counts.max()


def _cutoff2(rlist, dtype, device):
    return torch.tensor(rlist, dtype=dtype, device=device) ** 2


def _dense_rows(pos_a, valid_a, pos_b, valid_b, rlist, k):
    """Rows over `pos_a` against candidates `pos_b` (self excluded by
    index), in row chunks: (idx, mask, max count)."""
    n, m = pos_a.shape[0], pos_b.shape[0]
    cut2 = _cutoff2(rlist, pos_a.dtype, pos_a.device)
    cols = torch.arange(m, device=pos_a.device)
    out = []
    for r0 in range(0, n, _ROW_CHUNK):
        r1 = min(n, r0 + _ROW_CHUNK)
        d = pos_a[r0:r1, None, :] - pos_b[None, :, :]
        dist2 = torch.sum(d * d, dim=-1)
        rows = torch.arange(r0, r1, device=pos_a.device)
        mask = ((dist2 < cut2) & (rows[:, None] != cols[None, :])
                & valid_b[None, :] & valid_a[r0:r1, None])
        out.append(_rows_topk(mask, dist2, k))
    return (torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out]),
            torch.stack([o[2] for o in out]).max())


def build_neighbor_matrix_ext(pos_local, valid_local, pos_ext, valid_ext,
                              rlist: float, k_max: int):
    """Brute per-shard neighbor build over [S, n_cap] local rows and
    [S, n_ext] candidates: (idx [S, n_cap, k_max], mask, max count [S])."""
    res = [_dense_rows(pos_local[s], valid_local[s], pos_ext[s],
                       valid_ext[s], rlist, k_max)
           for s in range(pos_local.shape[0])]
    return tuple(torch.stack(x) for x in zip(*res))


@dataclasses.dataclass(frozen=True)
class BrickGrid:
    """Per-brick cell grid of the sharded neighbor build.

    A brick is its shard's fractional sub-volume of the box grown by the
    halo margin; all bricks have the same shape, and the brick's
    fractional origin is the only per-shard quantity."""

    ncells: tuple[int, int, int]  # cells per brick axis (margin included)
    margin_frac: tuple[float, float, float]  # halo margin, box fractions
    cell_capacity: int

    @property
    def total_cells(self) -> int:
        nx, ny, nz = self.ncells
        return nx * ny * nz

    @staticmethod
    def for_box(box_h, mesh_shape, rlist: float, cell_capacity: int,
                slack: float = 1.0):
        """None if a brick does not hold 2 cells of side rlist * slack on
        every axis (the brute build runs then)."""
        perp = perp_lengths(box_h)
        side = rlist * slack
        ncells, margins = [], []
        for a in range(3):
            brick = perp[a] / mesh_shape[a]
            n = int(np.floor((brick + 2.0 * rlist) / side))
            if n < 2:
                return None
            ncells.append(n)
            margins.append(float(rlist / perp[a]))
        return BrickGrid(ncells=tuple(ncells), margin_frac=tuple(margins),
                         cell_capacity=cell_capacity)


def _brick_cells(grid: BrickGrid, mesh_shape, lo, frac):
    """(cell coords [m, 3] clipped into the grid, in-grid [m]) of
    fractional coordinates in a brick whose origin is `lo` [3]."""
    dtype = frac.dtype
    extent = torch.tensor([1.0 / p for p in mesh_shape], dtype=dtype,
                          device=frac.device)
    marg = torch.tensor(grid.margin_frac, dtype=dtype, device=frac.device)
    u = (frac - lo[None, :] + marg[None, :]) / (extent + 2.0 * marg)[None, :]
    ncells = torch.tensor(grid.ncells, device=frac.device)
    cc = torch.minimum(torch.clamp((u * ncells).to(torch.int64), min=0),
                       ncells - 1)
    in_grid = torch.all((u >= 0.0) & (u < 1.0), dim=-1)
    return cc, in_grid


def _flat(ncells, cc):
    return (cc[..., 0] * ncells[1] + cc[..., 1]) * ncells[2] + cc[..., 2]


def _cell_table(grid: BrickGrid, ids, fill):
    """Dense [total_cells, cell_capacity] table of the rows of each cell
    (sort and rank, no atomics; `fill` where empty) and whether a cell held
    more."""
    sentinel = grid.total_cells
    order = torch.argsort(ids, stable=True)
    ids_sorted = ids[order]
    first = torch.searchsorted(ids_sorted, ids_sorted, side="left")
    rank = torch.arange(ids.shape[0], device=ids.device) - first
    ok = (rank < grid.cell_capacity) & (ids_sorted < sentinel)
    table = torch.full((sentinel + 1, grid.cell_capacity), fill,
                       dtype=torch.int64, device=ids.device)
    table[torch.where(ok, ids_sorted, sentinel),
          torch.clamp(rank, 0, grid.cell_capacity - 1)] = order
    over = (torch.where(ids_sorted < sentinel, rank, -1).max() + 1
            > grid.cell_capacity)
    return table[:-1], over


def _window_candidates(grid: BrickGrid, table, cc_rows, fill):
    """[r, 27 * cell_capacity] candidate rows of the 27-cell windows of
    cells `cc_rows` [r, 3] (`fill` outside the grid)."""
    ncells = torch.tensor(grid.ncells, device=cc_rows.device)
    offsets = torch.tensor(_OFFSETS, device=cc_rows.device)
    nbr = cc_rows[:, None, :] + offsets[None, :, :]
    cell_ok = torch.all((nbr >= 0) & (nbr < ncells), dim=-1)
    ncl = torch.minimum(torch.clamp(nbr, min=0), ncells - 1)
    cand = torch.where(cell_ok[..., None], table[_flat(grid.ncells, ncl)],
                       fill)
    return cand.reshape(cc_rows.shape[0], 27 * grid.cell_capacity)


def _brick_rows_one(grid, mesh_shape, lo, pos_local, valid_local, pos_ext,
                    valid_ext, box, rlist, k_max):
    n, m = pos_local.shape[0], pos_ext.shape[0]
    cc, in_grid = _brick_cells(grid, mesh_shape, lo,
                               box.to_fractional(pos_ext))
    ids = torch.where(valid_ext & in_grid, _flat(grid.ncells, cc),
                      grid.total_cells)
    table, over = _cell_table(grid, ids, m)
    cut2 = _cutoff2(rlist, pos_local.dtype, pos_local.device)
    out = []
    for r0 in range(0, n, _ROW_CHUNK):
        r1 = min(n, r0 + _ROW_CHUNK)
        cand = _window_candidates(grid, table, cc[r0:r1], m)
        cand_safe = torch.clamp(cand, max=m - 1)
        d = pos_local[r0:r1, None, :] - pos_ext[cand_safe]
        dist2 = torch.sum(d * d, dim=-1)
        rows = torch.arange(r0, r1, device=cand.device)
        mask = ((cand < m) & (dist2 < cut2) & (cand != rows[:, None])
                & valid_local[r0:r1, None])
        out.append(_rows_topk(mask, dist2, k_max, gather_from=cand_safe))
    idx = torch.cat([o[0] for o in out])
    mask = torch.cat([o[1] for o in out])
    max_deg = torch.stack([o[2] for o in out]).max()
    return idx, mask, torch.where(over, k_max + 1, max_deg)


def build_neighbor_matrix_brick(mesh, spec: DomainSpec, grid: BrickGrid,
                                pos_local, valid_local, pos_ext, valid_ext,
                                box, rlist: float, k_max: int):
    """O(n) per-brick cell-list neighbor build, the output of
    build_neighbor_matrix_ext (a clipped cell table reports max count
    k_max + 1). Halo positions are already shifted, so fractional
    coordinates are continuous around each brick and a brick-anchored
    grid needs no wrap."""
    lo = _lo(mesh, pos_local.dtype)
    res = [_brick_rows_one(grid, spec.mesh_shape, lo[s], pos_local[s],
                           valid_local[s], pos_ext[s], valid_ext[s], box,
                           rlist, k_max)
           for s in range(pos_local.shape[0])]
    return tuple(torch.stack(x) for x in zip(*res))


def auto_domain_spec(n_atoms: int, box_h, mesh_shape, rlist: float,
                     k_max: int = 160, slack: float = 1.3,
                     n_slack: float = 1.15) -> DomainSpec:
    """Capacities from the geometry: atom slots per shard from the mean
    brick occupancy, halo slots per stage from the rlist slab volumes
    (each axis sources the locals and the earlier stages' ghosts). A
    starting point: `DomainSimulation.run` grows whatever overflows."""
    perp = perp_lengths(box_h)
    ns = int(np.prod(mesh_shape))
    if ns == 1:
        n_slack = 1.0  # no migration imbalance on a single shard
    n_cap = int(-(-int(n_atoms / ns * n_slack + 64) // 8) * 8)
    n_src = n_cap
    halo = []
    for a in range(3):
        send_frac = min(rlist * mesh_shape[a] / perp[a], 1.0)
        cap = int(-(-int(n_src * send_frac * slack + 128) // 8) * 8)
        halo.append(cap)
        n_src += 2 * cap
    return DomainSpec(mesh_shape=tuple(mesh_shape), n_cap=n_cap,
                      halo_cap=tuple(halo), mig_cap=max(256, n_cap // 16),
                      k_max=k_max)


# ---------------------------------------------------------------------------
# Brick-local roll grid (the sharded asn engine)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BrickRollGrid:
    """Per-brick bin geometry of the sharded `pallas_asn` engine.

    The asn kernels (ops/aev_asn.py) take a periodic grid: windows wrap
    and the wing fold wraps. A brick is not periodic, so its grid carries
    one empty pad layer on each side: every occupied bin (owned atoms in
    the brick, ghosts in the rlist margin) is interior, its 27-bin window
    never wraps into atoms, and the wraps that happen touch empty bins
    only. The kernels then run unchanged per shard, their wrap shifts
    contract zero (the box cotangent flows through the halo stages'
    shifts instead), as the reference runs one kernel path on one GPU or
    many.

    The same for every shard; the brick's fractional origin, the only
    per-shard input, comes from the shard's mesh coordinates at bin
    time."""

    ncells: tuple[int, int, int]  # per axis, the 2 pad layers included
    cap: int  # slots per bin
    margin_frac: tuple[float, float, float]  # halo margin, box fractions
    cell_frac: tuple[float, float, float]  # bin side, box fractions

    @property
    def roll(self) -> crmod.RollGrid:
        """The RollGrid the asn kernels see."""
        return crmod.RollGrid(ncells=self.ncells, cap=self.cap)

    @staticmethod
    def for_box(box_h, mesh_shape, rlist: float, side_min: float, cap: int):
        """Bins of side >= side_min over one brick and its rlist margin,
        plus the empty pad layer; None if a brick holds no such bin."""
        perp = perp_lengths(box_h)
        ncells, margins, cells = [], [], []
        for a in range(3):
            margin = rlist / perp[a]
            occ_frac = 1.0 / mesh_shape[a] + 2.0 * margin
            n_occ = int(np.floor(occ_frac * perp[a] / side_min))
            if n_occ < 1:
                return None
            ncells.append(n_occ + 2)
            margins.append(float(margin))
            cells.append(float(occ_frac / n_occ))
        return BrickRollGrid(ncells=tuple(ncells), cap=cap,
                             margin_frac=tuple(margins),
                             cell_frac=tuple(cells))


def _bins_one(bgrid: BrickRollGrid, lo, pos_ext, species_ext, valid_ext,
              box) -> crmod.RollBins:
    m = pos_ext.shape[0]
    dev, dtype = pos_ext.device, pos_ext.dtype
    frac = box.to_fractional(pos_ext)
    marg = torch.tensor(bgrid.margin_frac, dtype=dtype, device=dev)
    cf = torch.tensor(bgrid.cell_frac, dtype=dtype, device=dev)
    nc = torch.tensor(bgrid.ncells, device=dev)
    # grid origin = brick origin - margin - one pad bin
    u = (frac - (lo - marg - cf)[None, :]) / (cf * nc.to(dtype))[None, :]
    cc = torch.minimum(torch.clamp((u * nc.to(dtype)).to(torch.int64),
                                   min=1), nc - 2)
    cell = _flat(bgrid.ncells, cc)
    total, cap = bgrid.roll.total, bgrid.cap
    ids = torch.where(valid_ext, cell, total)
    order = torch.argsort(ids, stable=True)
    ids_sorted = ids[order]
    first = torch.searchsorted(ids_sorted, ids_sorted, side="left")
    rank_sorted = torch.arange(m, device=dev) - first
    slot = torch.empty_like(rank_sorted)
    slot[order] = rank_sorted
    count_max = torch.where(ids_sorted < total, rank_sorted, -1).max() + 1
    ok = valid_ext & (slot < cap)
    species_grid = torch.full((total, cap), -1, dtype=torch.int32, device=dev)
    species_grid[cell[ok], slot[ok]] = species_ext[ok].to(torch.int32)
    inv = torch.full((total * cap,), m, dtype=torch.int64, device=dev)
    inv[cell[ok] * cap + slot[ok]] = torch.arange(m, device=dev)[ok]
    return crmod.RollBins(
        cell=torch.where(valid_ext, cell, 0),
        slot=torch.where(valid_ext, torch.clamp(slot, max=cap - 1), 0),
        species_grid=species_grid, mask_grid=species_grid >= 0,
        count_max=count_max, inv=inv.reshape(total, cap))


def build_bins_brick(mesh, bgrid: BrickRollGrid, pos_ext, species_ext,
                     valid_ext, box) -> list:
    """The RollBins of each shard's extended atoms ([S, n_ext] inputs), a
    list in shard order. Halo positions are already shifted, so the
    atoms fall in the occupied layers [1, ncells - 2] (clipped for edge
    rounding). Empty slots are left out of the grid and point at bin 0,
    slot 0, an empty pad bin whose AEV row is finite and masked later;
    the caller stops their position cotangent."""
    lo = _lo(mesh, pos_ext.dtype)
    return [_bins_one(bgrid, lo[s], pos_ext[s], species_ext[s],
                      valid_ext[s], box) for s in range(pos_ext.shape[0])]


# ---------------------------------------------------------------------------
# Ext-rowed neighbor build (the mirror tables of ops/nbr_grad.py)
# ---------------------------------------------------------------------------


def build_ext_rows(pos_local, valid_local, pos_ext, valid_ext, rlist: float,
                   k_ext: int):
    """[S, n_ext, k_ext] rows of EVERY extended atom over the LOCAL
    candidates only: the transposed structure `nbr_grad.build_mirror_ext`
    turns the force backward's scatter into a gather with. Brute;
    `build_ext_rows_brick` is the O(m) build. Returns (ext_idx, ext_mask,
    max count [S])."""
    res = [_dense_rows(pos_ext[s], valid_ext[s], pos_local[s],
                       valid_local[s], rlist, k_ext)
           for s in range(pos_local.shape[0])]
    return tuple(torch.stack(x) for x in zip(*res))


def _ext_rows_brick_one(grid, mesh_shape, lo, pos_local, valid_local,
                        pos_ext, valid_ext, box, rlist, k_ext):
    n, m = pos_local.shape[0], pos_ext.shape[0]
    cc, in_grid = _brick_cells(grid, mesh_shape, lo,
                               box.to_fractional(pos_ext))
    # bin the locals only (values are local rows; fill n)
    ids = torch.where(valid_local & in_grid[:n], _flat(grid.ncells, cc[:n]),
                      grid.total_cells)
    table, over = _cell_table(grid, ids, n)
    cut2 = _cutoff2(rlist, pos_local.dtype, pos_local.device)
    out = []
    for r0 in range(0, m, _ROW_CHUNK):
        r1 = min(m, r0 + _ROW_CHUNK)
        cand = _window_candidates(grid, table, cc[r0:r1], n)
        cand_safe = torch.clamp(cand, max=n - 1)
        d = pos_ext[r0:r1, None, :] - pos_local[cand_safe]
        dist2 = torch.sum(d * d, dim=-1)
        rows = torch.arange(r0, r1, device=cand.device)
        mask = ((cand < n) & (dist2 < cut2) & (cand != rows[:, None])
                & valid_ext[r0:r1, None])
        out.append(_rows_topk(mask, dist2, k_ext, gather_from=cand_safe))
    idx = torch.cat([o[0] for o in out])
    mask = torch.cat([o[1] for o in out])
    max_deg = torch.stack([o[2] for o in out]).max()
    return idx, mask, torch.where(over, k_ext + 1, max_deg)


def build_ext_rows_brick(mesh, spec: DomainSpec, grid: BrickGrid, pos_local,
                         valid_local, pos_ext, valid_ext, box, rlist: float,
                         k_ext: int):
    """O(m) brick-cell build of `build_ext_rows`: bins the local atoms (the
    candidates of every ext row), then gathers each ext atom's window. A
    ghost outside the brick-plus-margin grid is more than rlist from every
    local atom (the margin is rlist), so clipping its cell is safe."""
    lo = _lo(mesh, pos_local.dtype)
    res = [_ext_rows_brick_one(grid, spec.mesh_shape, lo[s], pos_local[s],
                               valid_local[s], pos_ext[s], valid_ext[s],
                               box, rlist, k_ext)
           for s in range(pos_local.shape[0])]
    return tuple(torch.stack(x) for x in zip(*res))
