"""Assignment-compacted AEV channels: the rebuild, the fused forward and
backward of the `pallas_asn` engine and the per-channel surface beside
them, sixteen hand-written Hopper kernels and their plain PyTorch versions.

Port of lammps_ani_tpu/ops/aev_asn.py (`aev_asn_fused`, `radial_aev_asn`,
`angular_aev_asn`; both angular pair stages). One coarse roll grid (bin
side >= Rcr + skin) serves both AEV channels:

  * At rebuild, each center's 27-bin window lanes within the keep radius
    (Rcr + skin) are ranked into per-species compact sections:
      inv [NC, cap, wpad]  window lane -> compact lane (dead: kpad - 1)
      idx [NC, cap, kpad]  compact lane -> window lane (dead: wpad)
    (`build_inv`, `build_idx`; wpad = 27 cap rounded up to 128).
  * Every step, one geometry pass through `idx` gives the radial columns of
    the present sections (16 shifts each, compact order) with the XTB
    repulsion energy in the last column, and the angular stage-2
    compaction: the first caps[s] in-Rca lanes of each section go to
    packed per-species slots (ux, uy, uz, d, fc, dfc), with `rank2` and
    the per-species cap deficit (`step_fused`).
  * The angular AEV sums every unordered pair of packed slots of every
    present species-pair block, from a static pair-lane table, per flat
    atom row (`packed_fwd`), optionally in occupancy tiers of narrower
    caps. The other pair stage (`pair_stage` "blocks" or "blocks_full",
    the JAX package's LAT_ANG_PACKED=0) launches one kernel per block and
    tier instead: the cross-species rectangle at scale 2 (`block_fwd`),
    the same-species strict upper triangle at scale 2 (`block_fwd_tri`)
    or, "blocks_full", the same-species full matrix less its diagonal at
    scale 1 (`block_fwd`); its backwards add each block's slot sums into
    one buffer (`block_bwd`, `block_bwd_tri`).
  * The backward recomputes the compact geometry for the radial and
    repulsion cotangents (`radial_gamma`), sums the pair cotangents into
    the packed slots on the tier rows the forward gathered (`packed_bwd`
    or the per-block backwards), chains the slots back to the compact
    lanes through `rank2` and adds the radial part, with the center force
    and the box cotangent (`chain_sum`), and sums the neighbor-role force
    onto the window lanes (`wing`: the kernel scatters over `idx`, the
    plain version gathers through `inv`);
    `aev_roll._fold_wing` rolls the window slabs back to their owner
    bins.

The per-channel surface runs each channel alone over the same frozen
assignment, so that a radial column and an angular block can be held
against a reference apart from one another:

  * `radial_aev_asn`: the radial part of the step alone
    (`radial_fwd_asn`); its backward gives the lane cotangents, the center
    force and the box cotangent in one kernel (`radial_bwd_asn`), then
    `wing` and the fold.
  * `angular_aev_asn`: stage 2 alone (`compact_asn`), then either pair
    stage; its backward is that stage's, the slot chain without a radial
    part (`decompact_chain`), `wing` and the fold.

The four per-channel kernels are built from the device functions of their
fused siblings, so the per-channel forwards equal `aev_asn_fused`'s
outputs bit for bit; the gradients agree to rounding (the fused backward
sums the channels before one wing gather and one fold).

Column layouts. `aev_asn_fused` always gives compact columns: the present
sections' radial blocks in `sections` order, the present species-pair
blocks in ascending torchani offset (`present_channels`). The per-channel
entry points give either (`compact_cols`): by default the full torchani
layout, with zero columns for species and pairs that no section holds.
`n_out` on all three entry points gives AEV rows, and does pair-block
work, for the first `n_out` binned atoms only (a domain's owned atoms);
the other atoms still take their neighbor-role force in the backward.

The host-side sizing and the flat-row glue keep their JAX names. The
JAX `_prep_asn` candidate planes have no counterpart: the plain versions
build candidates with `aev_roll._candidates` and the kernels compute
them from the [NC, cap] grid rows of `aev_roll._grid_inputs`.

Each wrapper launches its CUDA kernel (csrc/aev_asn.cu, built at first use
by ops/_build.py) for tensors on the card, and runs the plain PyTorch
version beside it for tensors on the CPU. Each entry point is one
autograd.Function on both devices: its backward is the backward wrappers.
The plain forwards are also differentiable torch ops, so `plain=True`
gives forces and the box cotangent by autograd alone: the oracle the
explicit backwards are held against.

Conventions (as the TPU kernels): empty slots are parked at 1e6 with
species -1; self is excluded by lane index (13 cap + slot); the keep test
is d2 <= keep_r^2; dist = sqrt(max(d2, 1e-12)) with d2 = (dx dx + dy dy)
+ dz dz; dead compact lanes sit at dist 1e6; dead packed slots hold
u = 0, d = 2 Rca + 10, fc = dfc = 0; rank2 (int16) of a lane without a
slot is 127; overflow and deficits are per species, max(count - cap) from a
-2^20 floor.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math

import numpy as np
import torch

from ..utils.profiling import phase
from . import aev_roll

_LANE = 128
DEAD_SLOT = _LANE - 1
DEFICIT_FLOOR = aev_roll.DEFICIT_FLOOR
PLAIN_CHUNK_ELEMS = 1 << 27
SOURCE = "aev_asn.cu"
ANGSTROM2BOHR = 1.8897261258369282
_MAX_S = 8
_MAX_BLOCKS = 28

# The angular pair stages (the JAX package's switches): "packed", one lane
# table over every block (LAT_ANG_PACKED=1, the default); "blocks", one
# launch per species-pair block, same-species blocks as their strict upper
# triangle (LAT_ANG_PACKED=0); "blocks_full", the same with same-species
# blocks as the full matrix less its diagonal (LAT_ANG_PACKED=0
# LAT_ANG_TRI=0).
PAIR_STAGES = ("packed", "blocks", "blocks_full")

# Plain-integer launch counts of the sixteen CUDA kernels (one per wrapper
# call that launches its kernel) and call counts of their plain versions
# made by the wrappers (CPU tensors). `reset_counts()` zeroes both.
LAUNCHES = {"build_inv": 0, "build_idx": 0, "step_fused": 0,
            "packed_fwd": 0, "radial_gamma": 0, "packed_bwd": 0,
            "chain_sum": 0, "wing": 0, "radial_fwd_asn": 0,
            "compact_asn": 0, "radial_bwd_asn": 0, "decompact_chain": 0,
            "block_fwd": 0, "block_bwd": 0, "block_fwd_tri": 0,
            "block_bwd_tri": 0}
PLAIN_CALLS = dict.fromkeys(LAUNCHES, 0)

# The TPU kernels of ops/aev_asn.py that the sixteen kernels replace.
REPLACES = {
    "build_inv": "lammps_ani_tpu/ops/aev_asn.py:243 _build_inv_kernel",
    "build_idx": "lammps_ani_tpu/ops/aev_asn.py:309 _build_idx_kernel",
    "step_fused": "lammps_ani_tpu/ops/aev_asn.py:1178 _step_fused_kernel",
    "packed_fwd": "lammps_ani_tpu/ops/aev_asn.py:1794 _packed_fwd_kernel",
    "radial_gamma":
        "lammps_ani_tpu/ops/aev_asn.py:850 _radial_gamma_only_kernel",
    "packed_bwd": "lammps_ani_tpu/ops/aev_asn.py:1833 _packed_bwd_kernel",
    "chain_sum": "lammps_ani_tpu/ops/aev_asn.py:2047 _chain_sum_kernel",
    "wing": "lammps_ani_tpu/ops/aev_asn.py:2083 _wing_kernel",
    "radial_fwd_asn":
        "lammps_ani_tpu/ops/aev_asn.py:762 _radial_fwd_asn_kernel",
    "compact_asn": "lammps_ani_tpu/ops/aev_asn.py:1153 _compact_asn_kernel",
    "radial_bwd_asn":
        "lammps_ani_tpu/ops/aev_asn.py:816 _radial_bwd_asn_kernel",
    "decompact_chain":
        "lammps_ani_tpu/ops/aev_asn.py:2013 _decompact_chain_kernel",
    "block_fwd": "lammps_ani_tpu/ops/aev_asn.py:1291 _block_fwd_kernel",
    "block_bwd": "lammps_ani_tpu/ops/aev_asn.py:1328 _block_bwd_kernel",
    "block_fwd_tri":
        "lammps_ani_tpu/ops/aev_asn.py:1503 _block_fwd_tri_kernel",
    "block_bwd_tri":
        "lammps_ani_tpu/ops/aev_asn.py:1519 _block_bwd_tri_kernel",
}


def reset_counts():
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _check_stage(pair_stage):
    if pair_stage not in PAIR_STAGES:
        raise ValueError(f"pair_stage {pair_stage!r}: expected one of "
                         f"{PAIR_STAGES}")


@dataclasses.dataclass(frozen=True)
class Assignment:
    """Frozen per-rebuild window-lane assignment."""

    idx: torch.Tensor  # [NC, cap, kpad] int16; dead = wpad
    inv: torch.Tensor  # [NC, cap, wpad] int16; dead = kpad - 1
    ovf: torch.Tensor  # [] max of ovf_sec; > 0: a section overflowed
    ovf_sec: torch.Tensor  # [num_species] per-species (count - k_s)


# ---------------------------------------------------------------------------
# Static layout (host side)
# ---------------------------------------------------------------------------


def _sec_offsets(sections):
    """sections ((species, k_s), ...) -> lane offsets + total."""
    offs, off = [], 0
    for _, k in sections:
        offs.append(off)
        off += k
    return tuple(offs), off


def _round_lane(n: int) -> int:
    return -(-n // _LANE) * _LANE


def _a_offsets(sections, caps):
    """Packed per-species offsets along the stage-2 slot axis:
    {species: (offset, cap)} for sections with caps > 0, and the total."""
    offs, off = {}, 0
    for s, _ in sections:
        if caps[s] == 0:
            continue
        offs[s] = (off, caps[s])
        off += caps[s]
    return offs, off


def sections_from_degrees(degs, margin):
    """Static per-species compact sections from measured keep-radius
    degrees: `margin` headroom, rounded to 4, then margin lanes trimmed so
    the section total stays at the 128-lane boundary of the measured
    demand."""
    degs = np.asarray(degs)
    out = [(s, int(-(-int(d * margin + 2) // 4) * 4))
           for s, d in enumerate(degs) if d > 0]
    floor = [(s, int(-(-(int(d) + 1) // 4) * 4))
             for s, d in enumerate(degs) if d > 0]
    total = sum(k for _, k in out)
    bound = -(-sum(k for _, k in floor) // _LANE) * _LANE
    while total > bound:
        # shave the section with the most margin headroom
        i = max(range(len(out)), key=lambda j: out[j][1] - floor[j][1])
        if out[i][1] - floor[i][1] <= 0:
            break
        out[i] = (out[i][0], out[i][1] - 4)
        total -= 4
    return tuple(out)


def _pair_count(caps, present):
    """Unordered slot pairs of all present species-pair blocks."""
    return sum(caps[s1] * (caps[s1] - 1) // 2 if s1 == s2
               else caps[s1] * caps[s2]
               for i, s1 in enumerate(present) for s2 in present[i:])


def _chunk1(a1, a2):
    """(c1, n_g): the TPU per-block kernels' arm-1 chunk (the most arm-1
    slots whose a2 pair lanes fit one 128-lane vreg) and chunk count."""
    c1 = max(1, min(_LANE // max(a2, 1), a1))
    return c1, -(-a1 // c1)


def _tri_block_cost(a):
    """Padded pair lanes of a same-species block's strict upper triangle
    (128-lane chunks; none below two slots)."""
    if a < 2:
        return 0
    return -(-(a * (a - 1) // 2) // _LANE) * _LANE


def _block_cost(a1, a2, same, tri):
    """Padded pair lanes per row of one species-pair block in the
    per-block stage: the TPU kernels' vreg padding, which sizes the
    tiers (the CUDA kernels have no such padding)."""
    if same and a1 < _LANE and tri:
        return _tri_block_cost(a1)
    c1, n_g = _chunk1(a1, a2)
    return n_g * (-(-(c1 * a2) // _LANE) * _LANE)


def search_tiers(cnt, caps, pair_stage="packed"):
    """Tier-0 caps over the measured per-row degree matrix `cnt` [n, S]
    that minimize the padded pair-lane work (fit rows run tier-0 caps,
    the rest the full `caps`) of `pair_stage`'s work model: one shared
    128-lane pad of the exact pair count ("packed"), or each block's own
    (`_block_cost`; "blocks" with triangle same-species blocks,
    "blocks_full" with full ones). Returns (caps0, fit_count) or None
    when one tier is as good."""
    _check_stage(pair_stage)
    caps = tuple(int(c) for c in caps)
    present = [s for s in range(len(caps)) if caps[s] > 0]
    if not present:
        return None
    cnt = np.asarray(cnt)
    n = cnt.shape[0]

    def work(cp):
        if pair_stage == "packed":
            return -(-_pair_count(cp, present) // _LANE) * _LANE
        return sum(_block_cost(cp[s1], cp[s2], s1 == s2,
                               pair_stage == "blocks")
                   for i, s1 in enumerate(present) for s2 in present[i:])

    w_full = work(caps)
    if len(present) > 4:
        # joint search blows up combinatorially; one robust quantile cut
        combos = [tuple(
            min(caps[s], max(4, -(-int(np.percentile(cnt[:, s], 97))
                                  // 4) * 4)) if caps[s] else 0
            for s in range(len(caps)))]
    else:
        cands = {s: list(range(4, caps[s] + 1, 4)) for s in present}
        combos = [tuple(dict(zip(present, combo)).get(s, 0)
                        for s in range(len(caps)))
                  for combo in itertools.product(*(cands[s]
                                                   for s in present))]
    best = None
    for cp in combos:
        fit = np.ones(n, bool)
        for s in present:
            fit &= cnt[:, s] <= cp[s]
        n0 = int(fit.sum())
        cost = 1.05 * n0 * work(cp) + 1.1 * (n - n0) * w_full
        if best is None or cost < best[0]:
            best = (cost, cp, n0)
    cost, cp, n0 = best
    if cp == caps or cost / (n * w_full) > 0.92:
        return None
    return cp, n0


def search_tier_ladder(cnt, caps, max_pre=2):
    """Multi-tier ladder under the packed pair-lane cost: per chunk budget
    below the full layout's, the caps with the most fitting rows; then the
    subset of up to `max_pre` such tiers (before the full-caps tier) with
    the least padded-lane work. Returns ((caps_t, n_fit_exclusive), ...)
    in ascending chunk count, or None when one tier is already best."""
    caps = tuple(int(c) for c in caps)
    present = [s for s in range(len(caps)) if caps[s] > 0]
    if not present:
        return None
    cnt = np.asarray(cnt)
    n = cnt.shape[0]

    chunks_full = -(-_pair_count(caps, present) // _LANE)
    if chunks_full <= 1:
        return None
    if len(present) > 4:
        combos = None  # the grid blows up; quantile candidates instead
    else:
        cands = {s: list(range(2, caps[s] + 1, 2)) for s in present}
        combos = [tuple(dict(zip(present, combo)).get(s, 0)
                        for s in range(len(caps)))
                  for combo in itertools.product(*(cands[s]
                                                   for s in present))]

    def fit_mask(cp):
        f = np.ones(n, bool)
        for s in present:
            f &= cnt[:, s] <= cp[s]
        return f

    best_at = {}
    if combos is None:
        for pc in (70, 85, 93, 97):
            cp = tuple(
                min(caps[s], max(2, -(-int(np.percentile(cnt[:, s], pc))
                                      // 2) * 2)) if caps[s] else 0
                for s in range(len(caps)))
            c = -(-_pair_count(cp, present) // _LANE)
            if c < chunks_full:
                nf = int(fit_mask(cp).sum())
                if c not in best_at or nf > best_at[c][0]:
                    best_at[c] = (nf, cp)
    else:
        for cp in combos:
            c = -(-_pair_count(cp, present) // _LANE)
            if c >= chunks_full:
                continue
            nf = int(fit_mask(cp).sum())
            if c not in best_at or nf > best_at[c][0]:
                best_at[c] = (nf, cp)
    cand = sorted((c, nf, cp) for c, (nf, cp) in best_at.items())
    if not cand:
        return None

    masks = {cp: fit_mask(cp) for _, _, cp in cand}
    best = (1.0 * n * chunks_full, ())  # untiered baseline
    subsets = [s for k in range(1, max_pre + 1)
               for s in itertools.combinations(cand, k)]
    for sub in subsets:
        assigned = np.zeros(n, bool)
        cost = 0.0
        rows = []
        for c, _, cp in sub:  # chunk-count ascending
            m = masks[cp] & ~assigned
            n_t = int(m.sum())
            cost += 1.06 * n_t * c
            rows.append((cp, n_t))
            assigned |= m
        cost += 1.1 * (n - int(assigned.sum())) * chunks_full
        # per-tier dispatch overhead, in chunk-equivalents per row
        cost += 0.12 * n * len(sub)
        if cost < best[0]:
            best = (cost, tuple(rows))
    if not best[1] or best[0] / (n * chunks_full) > 0.95:
        return None
    return best[1]


def present_channels(aev_spec, caps, sections):
    """Ascending torchani channel offsets (ch0) of the species-pair blocks
    present under `caps`/`sections`: the column map of the compact angular
    output."""
    a_offs, _ = _a_offsets(sections, tuple(caps))
    return tuple(sorted(pb[4] for pb in aev_roll._pair_blocks(aev_spec,
                                                               tuple(caps))
                        if pb[0] in a_offs and pb[1] in a_offs))


def _packed_layout(spec, caps, a_offs):
    """Static pair-lane layout: every present species-pair block's true
    pairs (strict upper triangle for same species, the rectangle for
    cross species; each unordered pair once, at scale 2), packed block
    after block in _pair_blocks order. Returns (blocks, q_total, n_chunks)
    with blocks = ((s1, s2, ch0, off1, off2, a1, a2, same, base), ...),
    base = the block's first pair lane; None without pairs."""
    blocks = []
    base = 0
    for s1, s2, a1, a2, ch0, same in aev_roll._pair_blocks(spec, caps):
        if s1 not in a_offs or s2 not in a_offs:
            continue
        q_b = a1 * (a1 - 1) // 2 if same else a1 * a2
        if q_b == 0:
            continue
        blocks.append((s1, s2, ch0, a_offs[s1][0], a_offs[s2][0], a1, a2,
                       same, base))
        base += q_b
    if not blocks:
        return None
    return tuple(blocks), base, -(-base // _LANE)


@functools.lru_cache(maxsize=None)
def _lane_table_np(spec, caps, a_offs_items):
    """[q_total, 3] int32 (slot 1, slot 2, block) of every pair lane."""
    blocks, q_total, _ = _packed_layout(spec, caps, dict(a_offs_items))
    rows = []
    for bi, (_, _, _, off1, off2, a1, a2, same, _) in enumerate(blocks):
        if same:
            rows += [(off1 + j, off1 + k, bi) for j in range(a1)
                     for k in range(j + 1, a1)]
        else:
            rows += [(off1 + j, off2 + k, bi) for j in range(a1)
                     for k in range(a2)]
    table = np.asarray(rows, np.int32).reshape(-1, 3)
    assert table.shape[0] == q_total
    return table


def _lane_table(spec, caps, a_offs, device):
    """The pair-lane table as an int32 tensor on `device` (cached)."""
    return _lane_table_on(spec, tuple(caps), tuple(a_offs.items()),
                          str(device))


@functools.lru_cache(maxsize=None)
def _lane_table_on(spec, caps, a_offs_items, device):
    return torch.as_tensor(_lane_table_np(spec, caps, a_offs_items),
                           device=device)


def _r_flat(n):
    """Flat-row block of the pair stage (the JAX row padding unit)."""
    r = 256
    while r > 8 and r >= 2 * n:
        r //= 2
    return r


def _norm_tiers(tiers, caps, r, n_pad2):
    """Static tier layout ((caps_t, rows_t), ...): tier caps clamped into
    [4, caps], row capacities rounded to the flat row block, the last tier
    at the full caps."""
    if not tiers or len(tiers) < 2:
        return None

    def rows(x):
        return max(r, min(-(-int(x) // r) * r, n_pad2))

    out = []
    for caps_t, rows_t in tiers[:-1]:
        eff = tuple(min(max(int(ct), 4), int(c)) if c else 0
                    for ct, c in zip(caps_t, caps))
        out.append((eff, rows(rows_t)))
    out.append((tuple(int(c) for c in caps), rows(tiers[-1][1])))
    return tuple(out)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the sixteen kernels
# ---------------------------------------------------------------------------


def _chunks(n, per_row):
    """Row slices holding at most PLAIN_CHUNK_ELEMS elements each."""
    step = max(1, PLAIN_CHUNK_ELEMS // max(1, per_row))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def _d2(dx, dy, dz):
    """(dx dx + dy dy) + dz dz, each operation rounded on its own (the
    kernels' order)."""
    return dx * dx + dy * dy + dz * dz


def build_inv_plain(pos_g, sp_g, h, ncells, sections, kpad, keep_radius):
    """(inv [NC, cap, wpad] int16, ovf [8] int32): each window lane's
    compact lane (off_s + its rank among the row's lanes of species s
    within the keep radius, self excluded, ascending lane), kpad - 1 for
    lanes no section keeps; ovf[s] = max over rows of count_s - k_s."""
    nc, cap = sp_g.shape
    w = 27 * cap
    wpad = _round_lane(w)
    dev = pos_g.device
    cp, cs = aev_roll._candidates(ncells, pos_g, sp_g, h, 1)
    offs, _ = _sec_offsets(sections)
    inv = torch.full((nc, cap, wpad), kpad - 1, dtype=torch.int16,
                     device=dev)
    ovf = torch.full((_MAX_S,), DEFICIT_FLOOR, dtype=torch.int32,
                     device=dev)
    r2 = keep_radius * keep_radius
    not_self = (torch.arange(w, device=dev)[None, :]
                != 13 * cap + torch.arange(cap, device=dev)[:, None])
    for rs in _chunks(nc, cap * w * 4):
        d = pos_g[rs][:, :, None, :] - cp[rs][:, None, :, :]
        keep = (_d2(d[..., 0], d[..., 1], d[..., 2]) <= r2) & not_self
        del d
        inv_c = inv[rs, :, :w]
        for (s, k_s), off in zip(sections, offs):
            m = keep & (cs[rs][:, None, :] == s)
            cum = torch.cumsum(m.to(torch.int32), dim=-1)
            inv_c = torch.where(m, (cum - 1 + off).to(torch.int16), inv_c)
            ovf[s] = torch.maximum(ovf[s], (cum[..., -1].max() - k_s)
                                   .to(torch.int32))
        inv[rs, :, :w] = inv_c
    return inv, ovf


def build_idx_plain(inv, kpad):
    """idx [NC, cap, kpad] int16: the window lane w with inv[.., w] == k,
    or wpad where none maps to k (the inverse of `inv` as a scatter)."""
    nc, cap, wpad = inv.shape
    flat = inv.reshape(nc * cap, wpad)
    out = []
    lanes = torch.arange(wpad, device=inv.device)
    for rs in _chunks(nc * cap, wpad * 2):
        v = flat[rs].to(torch.int64)
        v = torch.where((v >= 0) & (v < kpad - 1), v, kpad)  # kpad: trash
        idx = torch.full((v.shape[0], kpad + 1), wpad, dtype=torch.int64,
                         device=inv.device)
        idx.scatter_(1, v, lanes.expand_as(v))
        out.append(idx[:, :kpad].to(torch.int16))
    return torch.cat(out).reshape(nc, cap, kpad)


def _step_consts(spec, dtype):
    """The step's constants; in f32, basis values (tiny) and radial and
    repulsion terms (pmin) below 1e-30 flush to 0 (aev_asn.py :701,
    :749, :755)."""
    rc, eta, mu0, delta, nr = aev_roll.radial_consts(spec)
    rca = float(spec.angular_cutoff)
    tiny = 1e-30 if dtype == torch.float32 else 0.0
    return dict(rc=rc, eta=eta, mu0=mu0, delta=delta, nr=nr, rca=rca,
                big=2.0 * rca + 10.0, tiny=tiny, pmin=tiny)


def _rep_pair_plain(rep, dist, a_ij, z_ij, rin):
    """(e, de/d dist) of the repulsion half pair energy (aev_asn.py
    `_rep_pair`) in Hartree; 0 outside `rin`."""
    rc = rep.cutoff
    safe = torch.where(rin, dist * ANGSTROM2BOHR, 1.0)
    r_kf = (safe * torch.sqrt(safe) if rep.k_f == 1.5
            else torch.exp(rep.k_f * torch.log(safe)))
    core = z_ij / safe * torch.exp(-a_ij * r_kf)
    dcore_db = core * (-1.0 / safe - a_ij * rep.k_f * r_kf / safe)
    x = dist / rc
    if rep.cutoff_fn == "cosine":
        env = 0.5 * torch.cos(math.pi * x) + 0.5
        denv = (-0.5 * math.pi / rc) * torch.sin(math.pi * x)
    elif rep.cutoff_fn == "none":
        env = torch.ones_like(x)
        denv = torch.zeros_like(x)
    else:  # smooth
        u = 1.0 - torch.clamp(x * x, 0.0, 1.0 - 1e-6)
        env = torch.exp(1.0 - 1.0 / u)
        denv = env * (-2.0 * x / (rc * u * u))
    e = 0.5 * torch.where(rin, core * env, 0.0)
    de = 0.5 * torch.where(
        rin, dcore_db * ANGSTROM2BOHR * env + core * denv, 0.0)
    return e, de


def _rep_half_plain(rep, dist, a_ij, z_ij, rin, pmin):
    """Repulsion half pair energies, flushed below `pmin`."""
    e, _ = _rep_pair_plain(rep, dist, a_ij, z_ij, rin)
    return torch.where((e > pmin) | (e < -pmin), e, 0.0)


def _padded_candidates(ncells, pos_g, sp_g, h, wpad):
    """Candidate positions of every bin's 27-bin window, padded so that
    lane wpad (a dead idx) reads zeros, as the TPU gather does."""
    cp, _ = aev_roll._candidates(ncells, pos_g, sp_g, h, 1)
    return torch.nn.functional.pad(cp, (0, 0, 0, wpad + 1 - cp.shape[1]))


def _lane_geometry(cp, ctr, iv, wpad):
    """(ax, ay, az, valid, dist) [rows, cap, kpad] of the compact lanes
    `iv` (window lanes, int64): a = center - candidate; dead lanes sit at
    dist 1e6."""
    r, cap, kpad = iv.shape
    cand = torch.gather(cp, 1, iv.reshape(r, cap * kpad, 1)
                        .expand(-1, -1, 3)).reshape(r, cap, kpad, 3)
    ax = ctr[:, :, None, 0] - cand[..., 0]
    ay = ctr[:, :, None, 1] - cand[..., 1]
    az = ctr[:, :, None, 2] - cand[..., 2]
    valid = iv < wpad
    dist = torch.where(valid, torch.sqrt(torch.clamp(
        _d2(ax, ay, az), min=1e-12)), 1e6)
    return ax, ay, az, valid, dist


def _rep_tables(rep, sections, kpad, dtype, dev):
    """Repulsion parameters by compact lane (a_j, z_j [kpad]) and by
    center species (a_c, z_c [9]; entry 8: empty slot)."""
    offs, _ = _sec_offsets(sections)
    a_j = torch.zeros(kpad, dtype=dtype, device=dev)
    z_j = torch.zeros(kpad, dtype=dtype, device=dev)
    a_c = torch.zeros(_MAX_S + 1, dtype=dtype, device=dev)
    z_c = torch.zeros(_MAX_S + 1, dtype=dtype, device=dev)
    for (s, k_s), off in zip(sections, offs):
        a_j[off:off + k_s] = rep.alpha[s]
        z_j[off:off + k_s] = rep.zeff[s]
        a_c[s] = rep.alpha[s]
        z_c[s] = rep.zeff[s]
    return a_j, z_j, a_c, z_c


def _rep_lanes(rep, tables, sp_rows, valid, dist):
    """(a_ij, z_ij, rin) of the compact lanes of the centers `sp_rows`."""
    a_j, z_j, a_c, z_c = tables
    csp = torch.where(sp_rows >= 0, sp_rows.to(torch.int64), _MAX_S)
    a_ij = torch.sqrt(torch.clamp(a_j * a_c[csp][..., None], min=1e-12))
    z_ij = z_j * z_c[csp][..., None]
    return a_ij, z_ij, valid & (z_ij > 0) & (dist < rep.cutoff)


def _radial_layout(spec, sections, compact_cols):
    """(first radial column of each section, srl): compact columns follow
    the `sections` order, the full layout the species number, over all
    species of the spec."""
    nr = aev_roll.radial_consts(spec)[4]
    if compact_cols:
        return [si * nr for si in range(len(sections))], len(sections) * nr
    return [s * nr for s, _ in sections], spec.num_species * nr


def _radial_cols_plain(k, sections, layout, rep, rep_tab, sp_rows, valid,
                       dist):
    """[rows, cap, srl + 1]: the radial columns of one chunk of rows (NR
    per section at its column base, zeros elsewhere) and the repulsion
    energy in the last."""
    rc, nr, pmin = k["rc"], k["nr"], k["pmin"]
    offs, _ = _sec_offsets(sections)
    col0, srl = layout
    in_cut = valid & (dist <= rc)
    pref = 0.25 * torch.where(
        in_cut, 0.5 * torch.cos(dist * (math.pi / rc)) + 0.5, 0.0)
    x = torch.clamp(dist, max=rc + 1.0) - k["mu0"]
    cols = [None] * (srl + 1)
    for kk in range(nr):
        e = torch.exp(-k["eta"] * (x - kk * k["delta"]) ** 2)
        e = torch.where(e > k["tiny"], e, 0.0)
        t = pref * e
        t = torch.where(t > pmin, t, 0.0)
        for c0, (_, k_s), off in zip(col0, sections, offs):
            cols[c0 + kk] = t[..., off:off + k_s].sum(-1)
    if rep is not None:
        a_ij, z_ij, rin = _rep_lanes(rep, rep_tab, sp_rows, valid, dist)
        cols[srl] = _rep_half_plain(rep, dist, a_ij, z_ij, rin, pmin).sum(-1)
    zero = torch.zeros_like(dist[..., 0])
    return torch.stack([zero if c is None else c for c in cols], dim=-1)


def _stage2_plain(k, sections, caps, ax, ay, az, valid, dist, deficit):
    """(cmp [rows, cap, 6, atot], rank2 [rows, cap, kpad] int16) of one
    chunk of rows: the first caps[s] in-Rca lanes of each section go to
    packed slots; `deficit` [8] takes the running maxima in place."""
    rca = k["rca"]
    r, cap, kpad = dist.shape
    dev = dist.device
    offs, _ = _sec_offsets(sections)
    a_offs, atot = _a_offsets(sections, caps)
    lane_ids = torch.arange(kpad, device=dev)
    in_ang = valid & (dist <= rca)
    rank2 = torch.full((r, cap, kpad), DEAD_SLOT, dtype=torch.int16,
                       device=dev)
    src = torch.full((r, cap, atot + 1), kpad, dtype=torch.int64,
                     device=dev)  # lane of each slot; kpad: empty
    for (s, k_s), off in zip(sections, offs):
        if s not in a_offs:
            continue
        a_off, a_s = a_offs[s]
        m = in_ang[..., off:off + k_s]
        cum = torch.cumsum(m.to(torch.int32), dim=-1)
        deficit[s] = torch.maximum(
            deficit[s], (cum[..., -1].max() - a_s).to(torch.int32))
        rank = cum - 1
        keep = m & (rank < a_s)
        rank2[..., off:off + k_s] = torch.where(
            keep, rank + a_off, DEAD_SLOT).to(torch.int16)
        tgt = torch.where(keep, rank + a_off, atot).to(torch.int64)
        src.scatter_(2, tgt, lane_ids[off:off + k_s].expand_as(tgt))
    src = src[..., :atot]
    live = src < kpad
    cax, cay, caz = (torch.gather(torch.nn.functional.pad(a, (0, 1)), 2,
                                  src) for a in (ax, ay, az))
    cax, cay, caz = (torch.where(live, a, 0.0) for a in (cax, cay, caz))
    cd = torch.sqrt(torch.clamp(_d2(cax, cay, caz), min=1e-12))
    mask = cd > 1e-6
    d_safe = torch.where(mask, cd, k["big"])
    inv_d = 1.0 / d_safe
    inside = mask & (cd <= rca)
    fc = torch.where(inside, 0.5 * torch.cos(cd * (math.pi / rca)) + 0.5,
                     0.0)
    dfc = torch.where(inside, (-0.5 * math.pi / rca)
                      * torch.sin(cd * (math.pi / rca)), 0.0)
    cmp = torch.stack([cax * inv_d, cay * inv_d, caz * inv_d, d_safe, fc,
                       dfc], dim=2)
    return cmp, rank2


def _step_plain(pos_g, sp_g, h, idx, ncells, spec, sections, caps, rep,
                compact_cols, radial, stage2):
    """One geometry pass through `idx` over chunks of rows, with the
    radial part, the stage-2 part or both: (rad, cmp, rank2, deficit),
    None for the part left out."""
    nc, cap = sp_g.shape
    kpad = idx.shape[-1]
    wpad = _round_lane(27 * cap)
    dev, dtype = pos_g.device, pos_g.dtype
    k = _step_consts(spec, dtype)
    cp = _padded_candidates(ncells, pos_g, sp_g, h, wpad)
    deficit = torch.full((_MAX_S,), DEFICIT_FLOOR, dtype=torch.int32,
                         device=dev)
    layout = _radial_layout(spec, sections, compact_cols)
    rep_tab = (_rep_tables(rep, sections, kpad, dtype, dev)
               if radial and rep is not None else None)
    rads, cmps, rank2s = [], [], []
    for rs in _chunks(nc, cap * kpad * 24):
        iv = idx[rs].to(torch.int64)
        ax, ay, az, valid, dist = _lane_geometry(cp[rs], pos_g[rs], iv, wpad)
        if radial:
            rads.append(_radial_cols_plain(k, sections, layout, rep, rep_tab,
                                           sp_g[rs], valid, dist))
        if stage2:
            cmp, rank2 = _stage2_plain(k, sections, caps, ax, ay, az, valid,
                                       dist, deficit)
            cmps.append(cmp)
            rank2s.append(rank2)
    return (torch.cat(rads) if radial else None,
            torch.cat(cmps) if stage2 else None,
            torch.cat(rank2s) if stage2 else None,
            deficit if stage2 else None)


def step_fused_plain(pos_g, sp_g, h, idx, ncells, spec, sections, caps,
                     rep):
    """(rad [NC, cap, srl+1], cmp [NC, cap, 6, atot], rank2 [NC, cap,
    kpad] int16, deficit [8] int32): one geometry pass through `idx`.

    rad: radial columns si*NR + k of the present sections, the repulsion
    energy last; cmp: the stage-2 packed slots, fields (ux, uy, uz, d,
    fc, dfc); rank2: each compact lane's packed slot (127: none); deficit:
    per species max over rows of (count within Rca - caps[s])."""
    return _step_plain(pos_g, sp_g, h, idx, ncells, spec, sections, caps,
                       rep, True, True, True)


def radial_fwd_asn_plain(pos_g, sp_g, h, idx, ncells, spec, sections, rep,
                         compact_cols=True):
    """rad [NC, cap, srl + 1]: the radial part of `step_fused_plain` alone.
    Compact columns: si*NR + k in `sections` order (srl = NR x sections);
    full layout: s*NR + k over all species of the spec, zeros for those no
    section holds (srl = NR x num_species). The repulsion energy is the
    last column in both."""
    return _step_plain(pos_g, sp_g, h, idx, ncells, spec, sections, None,
                       rep, compact_cols, True, False)[0]


def compact_asn_plain(pos_g, sp_g, h, idx, ncells, spec, sections, caps):
    """(cmp [NC, cap, 6, atot], rank2 [NC, cap, kpad] int16, deficit [8]
    int32): the stage-2 part of `step_fused_plain` alone."""
    return _step_plain(pos_g, sp_g, h, idx, ncells, spec, sections, caps,
                       None, True, False, True)[1:]


def packed_fwd_plain(cat, spec, caps_t, a_offs):
    """[rows, n_blocks * 32] angular columns of every row of `cat` [rows,
    5 atot] (fields ux, uy, uz, d, fc of the packed slots): block b's pair
    lanes summed into columns b*32 + j*8 + m, times 2."""
    rows = cat.shape[0]
    atot = cat.shape[1] // 5
    blocks, q_total, _ = _packed_layout(spec, caps_t, a_offs)
    cst = aev_roll.angular_consts(spec, cat.dtype)
    pmin = 1e-30 if cat.dtype == torch.float32 else 0.0
    tab = _lane_table(spec, caps_t, a_offs, cat.device).to(torch.int64)
    i1, i2 = tab[:, 0], tab[:, 1]
    outs = []
    for rs in _chunks(rows, q_total * 64):
        c = cat[rs].reshape(-1, 5, atot)
        u = c[:, 0:3]
        pt = aev_roll._pair_terms_core(
            cst, u[:, :, i1].transpose(1, 2), u[:, :, i2].transpose(1, 2),
            c[:, 3, i1], c[:, 3, i2], c[:, 4, i1], c[:, 4, i2])
        cols = []
        for blk in blocks:
            lo = blk[8]
            hi = lo + (blk[5] * (blk[5] - 1) // 2 if blk[7]
                       else blk[5] * blk[6])
            for e in pt["e_j"]:
                f2 = pt["fc12"][:, lo:hi] * e[:, lo:hi]
                for f1 in pt["f1_m"]:
                    v = f2 * f1[:, lo:hi]
                    cols.append(torch.where(v > pmin, v, 0.0).sum(-1))
        outs.append(2.0 * torch.stack(cols, dim=-1))
    return torch.cat(outs)


def _lane_dh(sh_rows, idx_rows, cap, g):
    """[3, 3] box cotangent of the lane cotangents `g` [rows, cap, 3, kpad]:
    dh[m, c] = -sum over lanes of S_m g_c, S the wrap shift of the lane's
    window offset idx // cap from `sh_rows` [rows, 28, 3] (offset 27, a
    dead lane: none)."""
    r, _, kpad = idx_rows.shape
    o_k = torch.clamp(idx_rows.to(torch.int64) // cap, max=27)
    s_k = torch.gather(sh_rows, 1, o_k.reshape(-1, cap * kpad, 1)
                       .expand(-1, -1, 3)).reshape(-1, cap, kpad, 3)
    return -torch.einsum("nakm,nack->mc", s_k, g)


def _shift_tables(ncells, dtype, device):
    """[NC, 28, 3] wrap shifts of the 27 window offsets; entry 27: 0."""
    sh = aev_roll._wrap_shift_tables(ncells, 1, dtype, device)
    return torch.nn.functional.pad(sh, (0, 0, 0, 1))


def _radial_gamma_plain(pos_g, sp_g, h, idx, ga, ncells, spec, sections, rep,
                        compact_cols, sums):
    """The radial backward over chunks of rows: (g, fcen, dh), the last
    two None without `sums`."""
    nc, cap = sp_g.shape
    kpad = idx.shape[-1]
    wpad = _round_lane(27 * cap)
    dev, dtype = pos_g.device, pos_g.dtype
    k = _step_consts(spec, dtype)
    rc, nr = k["rc"], k["nr"]
    offs, _ = _sec_offsets(sections)
    cp = _padded_candidates(ncells, pos_g, sp_g, h, wpad)
    if rep is not None:
        rep_tab = _rep_tables(rep, sections, kpad, dtype, dev)
    # lane -> radial column base; lanes of no section: column 0 with
    # weight 0
    col0 = torch.zeros(kpad, dtype=torch.int64, device=dev)
    in_sec = torch.zeros(kpad, dtype=dtype, device=dev)
    for c0, (_, k_s), off in zip(
            _radial_layout(spec, sections, compact_cols)[0], sections, offs):
        col0[off:off + k_s] = c0
        in_sec[off:off + k_s] = 1.0
    sh = _shift_tables(ncells, dtype, dev) if sums else None
    outs, fcens = [], []
    dh = pos_g.new_zeros((3, 3)) if sums else None
    for rs in _chunks(nc, cap * kpad * 24):
        iv = idx[rs].to(torch.int64)
        ax, ay, az, valid, dist = _lane_geometry(cp[rs], pos_g[rs], iv, wpad)
        in_cut = valid & (dist <= rc)
        fc = torch.where(in_cut, 0.5 * torch.cos(dist * (math.pi / rc)) + 0.5,
                         0.0)
        dfc = torch.where(in_cut, (-0.5 * math.pi / rc)
                          * torch.sin(dist * (math.pi / rc)), 0.0)
        x = torch.clamp(dist, max=rc + 1.0) - k["mu0"]
        g = ga[rs]
        gamma = torch.zeros_like(dist)
        for kk in range(nr):
            xk = x - kk * k["delta"]
            e = torch.exp(-k["eta"] * xk * xk)
            e = torch.where(e > k["tiny"], e, 0.0)
            db = 0.25 * e * (dfc - (2.0 * k["eta"]) * xk * fc)
            gamma = gamma + db * (g[:, :, col0 + kk] * in_sec)
        if rep is not None:
            a_ij, z_ij, rin = _rep_lanes(rep, rep_tab, sp_g[rs], valid, dist)
            _, de = _rep_pair_plain(rep, dist, a_ij, z_ij, rin)
            gamma = gamma + de * g[:, :, -1:]
        gd = gamma / dist
        out = torch.stack([gd * ax, gd * ay, gd * az], dim=2)
        outs.append(out)
        if sums:
            fcens.append(out.sum(-1))
            dh = dh + _lane_dh(sh[rs], idx[rs], cap, out)
    return torch.cat(outs), (torch.cat(fcens) if sums else None), dh


def radial_gamma_plain(pos_g, sp_g, h, idx, ga, ncells, spec, sections, rep):
    """gr [NC, cap, 3, kpad]: the compact lanes' vector cotangents from the
    radial and repulsion cotangent `ga` [NC, cap, srl+1] (the derivative
    of `step_fused`'s rad with respect to a = center - candidate):
    gamma (a / d) with gamma = sum_k ga[si*NR + k] 0.25 e_k (dfc - 2 eta
    x_k fc) + ga[srl] dE_rep/dd. Dead lanes give 0."""
    return _radial_gamma_plain(pos_g, sp_g, h, idx, ga, ncells, spec,
                               sections, rep, True, False)[0]


def radial_bwd_asn_plain(pos_g, sp_g, h, idx, ga, ncells, spec, sections,
                         rep, compact_cols=True):
    """(g [NC, cap, 3, kpad], fcen [NC, cap, 3], dh [3, 3]): the lane
    cotangents of `radial_gamma_plain` for a cotangent `ga` of
    `radial_fwd_asn`'s output in either column layout, the center force
    (their lane sum) and the box cotangent of the lanes' wrap shifts."""
    return _radial_gamma_plain(pos_g, sp_g, h, idx, ga, ncells, spec,
                               sections, rep, compact_cols, True)


def packed_bwd_plain(cat, ga_t, spec, caps_t, a_offs):
    """[rows, 5 atot] per-slot cotangent sums (of ux, uy, uz, d, fc, field
    after field) of the rows of `cat` for the cotangent `ga_t` [rows,
    n_blocks * 32] of `packed_fwd`'s columns: both arms of every pair
    lane."""
    rows = cat.shape[0]
    atot = cat.shape[1] // 5
    blocks, q_total, _ = _packed_layout(spec, caps_t, a_offs)
    cst = aev_roll.angular_consts(spec, cat.dtype)
    n_a, nsz = cst["n_a"], len(cst["cos_m"])
    tab = _lane_table(spec, caps_t, a_offs, cat.device).to(torch.int64)
    i1, i2, bi = tab[:, 0], tab[:, 1], tab[:, 2]
    outs = []
    for rs in _chunks(rows, q_total * 128):
        c = cat[rs].reshape(-1, 5, atot)
        u = c[:, 0:3]
        pt = aev_roll._pair_terms_core(
            cst, u[:, :, i1].transpose(1, 2), u[:, :, i2].transpose(1, 2),
            c[:, 3, i1], c[:, 3, i2], c[:, 4, i1], c[:, 4, i2])
        g = 2.0 * ga_t[rs].reshape(-1, len(blocks), n_a, nsz)[:, bi]
        dcos, drmean, dfc12 = _pair_grads(cst, pt, g)
        out = c.new_zeros((c.shape[0], 5, atot))
        for i_own, u_other, fc_other in ((i1, pt["u2"], pt["fc2"]),
                                         (i2, pt["u1"], pt["fc1"])):
            arm = torch.cat([(dcos[..., None] * u_other).transpose(1, 2),
                             (0.5 * drmean)[:, None], (dfc12 * fc_other)
                             [:, None]], dim=1)
            out.index_add_(2, i_own, arm)
        outs.append(out.reshape(-1, 5 * atot))
    return torch.cat(outs) if outs else cat.new_zeros((0, 5 * atot))


def _pair_grads(cst, pt, g):
    """(dcos, drmean, dfc12) of every slot pair of the pair terms `pt` for
    the cotangent `g` [..., n_a, n_z] of their 32 columns (scale
    included), broadcast against the pair axes; drmean is 0 where the
    radial mean was clamped (d1 + d2 > 2 (Rca + 1))."""
    n_a, nsz = cst["n_a"], len(cst["cos_m"])
    df2 = [torch.zeros_like(pt["fc12"]) for _ in range(n_a)]
    dcos = torch.zeros_like(pt["fc12"])
    for m in range(nsz):
        f1 = pt["f1_m"][m]
        df1 = torch.zeros_like(dcos)
        for j, e in enumerate(pt["e_j"]):
            df1 = df1 + g[..., j, m] * (pt["fc12"] * e)
            df2[j] = df2[j] + g[..., j, m] * f1
        dbase = df1 * (cst["zeta"] / pt["base_m"][m]) * f1
        dcos = dcos + dbase * 0.5 * (
            cst["cos_m"][m] - pt["c95"] / pt["sv"] * cst["sin_m"][m]) * 0.95
    drmean = torch.zeros_like(dcos)
    dfc12 = torch.zeros_like(dcos)
    for j, e in enumerate(pt["e_j"]):
        drmean = drmean + df2[j] * pt["fc12"] * e * (
            -2.0 * cst["eta"]) * (pt["x2"] - j * cst["delta"])
        dfc12 = dfc12 + df2[j] * e
    drmean = torch.where(pt["d1"] + pt["d2"] <= 2.0 * (cst["rca"] + 1.0),
                         drmean, 0.0)
    return dcos, drmean, dfc12


def _block_fields(cat, off, a):
    """[rows, 5, a]: the five slot fields (ux, uy, uz, d, fc) of an arm,
    the `a` slots from `off` of the flat rows `cat` [rows, 5 atot]."""
    atot = cat.shape[1] // 5
    return cat.reshape(cat.shape[0], 5, atot)[:, :, off:off + a]


def _block_terms(cst, c1, c2, same):
    """Pair terms [rows, a1, a2] of every (arm-1 slot, arm-2 slot) of one
    block from the arms' fields; `same`: fc12 is 0 on the diagonal."""
    pt = aev_roll._pair_terms_core(
        cst, c1[:, 0:3].transpose(1, 2)[:, :, None],
        c2[:, 0:3].transpose(1, 2)[:, None], c1[:, 3, :, None],
        c2[:, 3, None], c1[:, 4, :, None], c2[:, 4, None])
    if same:
        pt["diag"] = torch.eye(c1.shape[2], dtype=torch.bool,
                               device=c1.device)
        pt["fc12"] = torch.where(pt["diag"], 0.0, pt["fc12"])
    return pt


def _tri_terms(cst, c, j, k):
    """Pair terms [rows, q] of the slot pairs (j, k) of one arm's fields."""
    return aev_roll._pair_terms_core(
        cst, c[:, 0:3, j].transpose(1, 2), c[:, 0:3, k].transpose(1, 2),
        c[:, 3, j], c[:, 3, k], c[:, 4, j], c[:, 4, k])


def _columns(pt, scale):
    """[rows, 32]: the pair terms' column sums j*8 + m, times `scale`."""
    cols = []
    for e in pt["e_j"]:
        f2 = pt["fc12"] * e
        for f1 in pt["f1_m"]:
            cols.append((f2 * f1).flatten(1).sum(1))
    return scale * torch.stack(cols, dim=-1)


def block_fwd_plain(cat, spec, off1, a1, off2, a2, same):
    """[rows, 32] angular columns j*8 + m of one species-pair block from
    the flat rows `cat` [rows, 5 atot] (aev_asn.py `_block_fwd_kernel`):
    every (arm-1 slot, arm-2 slot) pair of the slots [off1, off1 + a1) and
    [off2, off2 + a2), summed as they come. Cross species at scale 2;
    `same` (off2 = off1, a2 = a1): the full matrix at scale 1, its
    diagonal masked (fc12 = 0)."""
    cst = aev_roll.angular_consts(spec, cat.dtype)
    outs = [_columns(_block_terms(cst, _block_fields(cat[rs], off1, a1),
                                  _block_fields(cat[rs], off2, a2), same),
                     1.0 if same else 2.0)
            for rs in _chunks(cat.shape[0], a1 * a2 * 64)]
    return torch.cat(outs) if outs else cat.new_zeros((0, 32))


def block_fwd_tri_plain(cat, spec, off, a):
    """[rows, 32] angular columns of a same-species block as its strict
    upper triangle at scale 2 (aev_asn.py `_block_fwd_tri_kernel`; each
    unordered pair once: the terms are symmetric)."""
    cst = aev_roll.angular_consts(spec, cat.dtype)
    j, k = torch.triu_indices(a, a, 1, device=cat.device)
    outs = [_columns(_tri_terms(cst, _block_fields(cat[rs], off, a), j, k),
                     2.0)
            for rs in _chunks(cat.shape[0], a * a * 32)]
    return torch.cat(outs) if outs else cat.new_zeros((0, 32))


def _arm_sums(cst, pt, g, u1, u2, fc1, fc2):
    """The pair cotangents of `pt` for the column cotangent `g`, as the
    two arms' terms (ux, uy, uz, d, fc) [rows, 5, *pair axes]: arm 1
    (dcos u2, drmean / 2, dfc12 fc2) and arm 2 (dcos u1, drmean / 2,
    dfc12 fc1)."""
    dcos, drmean, dfc12 = _pair_grads(cst, pt, g)
    if "diag" in pt:
        dfc12 = torch.where(pt["diag"], 0.0, dfc12)
    half = (0.5 * drmean)[:, None]
    return (torch.cat([dcos[:, None] * u2, half, (dfc12 * fc2)[:, None]], 1),
            torch.cat([dcos[:, None] * u1, half, (dfc12 * fc1)[:, None]], 1))


def block_bwd_plain(cat, ga, spec, off1, a1, off2, a2, same, acc):
    """Adds one species-pair block's per-slot cotangent sums of (ux, uy,
    uz, d, fc) into `acc` [rows, 5 atot] in place and returns it
    (aev_asn.py `_block_bwd_kernel`): `ga` [rows, 32] is the cotangent of
    `block_fwd_plain`'s columns; arm 1's terms land on its slots, arm 2's
    on its own, added to arm 1's for a same-species block."""
    cst = aev_roll.angular_consts(spec, cat.dtype)
    n_a, nsz = cst["n_a"], len(cst["cos_m"])
    atot = cat.shape[1] // 5
    view = acc.view(-1, 5, atot)
    scale = 1.0 if same else 2.0
    for rs in _chunks(cat.shape[0], a1 * a2 * 128):
        c1 = _block_fields(cat[rs], off1, a1)
        c2 = _block_fields(cat[rs], off2, a2)
        pt = _block_terms(cst, c1, c2, same)
        g = scale * ga[rs].reshape(-1, 1, 1, n_a, nsz)
        arm1, arm2 = _arm_sums(cst, pt, g, c1[:, 0:3, :, None],
                               c2[:, 0:3, None], c1[:, 4, :, None],
                               c2[:, 4, None])
        arm1, arm2 = arm1.sum(3), arm2.sum(2)
        if same:
            view[rs, :, off1:off1 + a1] += arm1 + arm2
        else:
            view[rs, :, off1:off1 + a1] += arm1
            view[rs, :, off2:off2 + a2] += arm2
    return acc


def block_bwd_tri_plain(cat, ga, spec, off, a, acc):
    """Adds a same-species block's per-slot cotangent sums of its strict
    upper triangle into `acc` [rows, 5 atot] in place and returns it
    (aev_asn.py `_block_bwd_tri_kernel`): slot j takes its pairs' arm-1
    terms and, added to them, its pairs' arm-2 terms."""
    cst = aev_roll.angular_consts(spec, cat.dtype)
    n_a, nsz = cst["n_a"], len(cst["cos_m"])
    atot = cat.shape[1] // 5
    view = acc.view(-1, 5, atot)
    j, k = torch.triu_indices(a, a, 1, device=cat.device)
    for rs in _chunks(cat.shape[0], a * a * 64):
        c = _block_fields(cat[rs], off, a)
        pt = _tri_terms(cst, c, j, k)
        g = 2.0 * ga[rs].reshape(-1, 1, n_a, nsz)
        arm1, arm2 = _arm_sums(cst, pt, g, c[:, 0:3, j], c[:, 0:3, k],
                               c[:, 4, j], c[:, 4, k])
        zero = c.new_zeros(c.shape)
        view[rs, :, off:off + a] += (zero.index_add(2, j, arm1)
                                     + zero.index_add(2, k, arm2))
    return acc


def _chain_plain(rank2, idx, cmp, gsum, gr, ncells, spec):
    """The slot chain over chunks of rows, added to the radial part `gr`
    where one is given: (gt, fcen, dh)."""
    nc, cap, kpad = idx.shape
    atot = cmp.shape[-1]
    sh = _shift_tables(ncells, cmp.dtype, cmp.device)
    gts, fcens = [], []
    dh = cmp.new_zeros((3, 3))
    for rs in _chunks(nc, cap * kpad * 16):
        c, g = cmp[rs], gsum[rs]
        u, d, dfc = c[:, :, 0:3], c[:, :, 3], c[:, :, 5]
        gu, gd, gfc = g[:, :, 0:3], g[:, :, 3], g[:, :, 4]
        mask = d < spec.angular_cutoff + 5.0
        inv_d = torch.where(mask, 1.0 / d, 0.0)
        g_cd = torch.where(
            mask, gd + gfc * dfc - torch.sum(gu * u, dim=2) * inv_d, 0.0)
        gv = gu * inv_d[:, :, None] + g_cd[:, :, None] * u
        gv = torch.nn.functional.pad(gv, (0, 1))  # slot atot: zeros
        r2 = rank2[rs].to(torch.int64)
        r2 = torch.where(r2 < atot, r2, atot)
        gt = torch.gather(gv, 3, r2[:, :, None, :].expand(-1, -1, 3, -1))
        if gr is not None:
            gt = gt + gr[rs]
        dh = dh + _lane_dh(sh[rs], idx[rs], cap, gt)
        gts.append(gt)
        fcens.append(gt.sum(-1))
    return torch.cat(gts), torch.cat(fcens), dh


def chain_sum_plain(rank2, idx, cmp, gsum, gr, ncells, spec):
    """(gt [NC, cap, 3, kpad], fcen [NC, cap, 3], dh [3, 3]): the packed
    slots' cotangents `gsum` [NC, cap, 5, atot] chained to vector
    cotangents (slots with d < Rca + 5: g_cd = gd + gfc dfc - (gu . u) / d,
    g = gu / d + g_cd u), gathered to the compact lanes through `rank2`
    (no slot: 0) and added to the radial part `gr`; the center force is
    the lane sum; dh[m, c] = -sum over lanes of S_m g_c with S the wrap
    shift of the lane's window offset idx // cap (dead lanes: none)."""
    return _chain_plain(rank2, idx, cmp, gsum, gr, ncells, spec)


def decompact_chain_plain(rank2, idx, cmp, gsum, ncells, spec):
    """(gt, fcen, dh) of `chain_sum_plain` without a radial part: the slot
    chain through `rank2` alone."""
    return _chain_plain(rank2, idx, cmp, gsum, None, ncells, spec)


def wing_plain(gt, inv):
    """wing [NC, 27 cap, 3]: the neighbor-role force on the window lanes,
    wing[b, w, c] = -sum over the bin's slots of gt[b, slot, c, inv[b,
    slot, w]] (a dead inv is kpad - 1, a lane where gt is 0)."""
    nc, cap = gt.shape[:2]
    w = 27 * cap
    outs = []
    for rs in _chunks(nc, cap * w * 6):
        iv = inv[rs, :, None, :w].to(torch.int64).expand(-1, -1, 3, -1)
        outs.append(-torch.gather(gt[rs], 3, iv).sum(1).transpose(1, 2))
    return torch.cat(outs).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers: the CUDA kernel for tensors on the card, the plain
# version for tensors on the CPU, an error for anything else
# ---------------------------------------------------------------------------


def _route(name, *tensors) -> bool:
    """True: launch the kernel. False: run the plain version (CPU)."""
    devs = {t.device.type for t in tensors}
    if devs == {"cuda"}:
        return True
    if devs == {"cpu"}:
        PLAIN_CALLS[name] += 1
        return False
    raise ValueError(f"{name}: tensors on devices {sorted(devs)}; expected "
                     "all on cuda or all on cpu")


def _suffix(name, dtype):
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"{name}: dtype {dtype} not supported")


def _launch(name, entry, iparams, fparams, *tensors):
    """Call the C entry point `entry` of aev_asn.cu on the current stream."""
    from . import _build

    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous tensor {tuple(t.shape)}")
    fn = _build.entry(entry, len(tensors) + 3, SOURCE)
    ip = np.ascontiguousarray(iparams, np.int32)
    fp = np.ascontiguousarray(fparams, np.float64)
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    err = fn(ip.ctypes.data, fp.ctypes.data,
             *[t.data_ptr() for t in tensors], stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed: "
                           f"{_build.error_string(err, SOURCE)} ({err})")
    LAUNCHES[name] += 1


def _pad8(xs, fill=0):
    xs = list(xs)
    if len(xs) > _MAX_S:
        raise ValueError(f"at most {_MAX_S} species sections, got {len(xs)}")
    return xs + [fill] * (_MAX_S - len(xs))


def _sec_ints(sections):
    offs, _ = _sec_offsets(sections)
    return ([len(sections)] + _pad8(s for s, _ in sections) + _pad8(offs)
            + _pad8(k for _, k in sections))


def _check_grid(name, ncells, pos_g, sp_g, h):
    nc = ncells[0] * ncells[1] * ncells[2]
    cap = sp_g.shape[-1]
    if not (sp_g.shape == (nc, cap) and sp_g.dtype == torch.int32
            and pos_g.shape == (nc, cap, 3) and h.shape == (3, 3)
            and h.dtype == pos_g.dtype):
        raise ValueError(
            f"{name}: grid inputs do not fit ncells {tuple(ncells)}: pos_g "
            f"{tuple(pos_g.shape)} {pos_g.dtype}, sp_g {tuple(sp_g.shape)} "
            f"{sp_g.dtype}, h {tuple(h.shape)} {h.dtype}")


def build_inv(pos_g, sp_g, h, ncells, sections, kpad, keep_radius):
    """(inv, ovf) (replaces aev_asn._build_inv_kernel)."""
    if not _route("build_inv", pos_g, sp_g, h):
        return build_inv_plain(pos_g, sp_g, h, ncells, sections, kpad,
                               keep_radius)
    _check_grid("build_inv", ncells, pos_g, sp_g, h)
    nc, cap = sp_g.shape
    wpad = _round_lane(27 * cap)
    inv = torch.empty((nc, cap, wpad), dtype=torch.int16,
                      device=pos_g.device)
    ovf = torch.full((_MAX_S,), DEFICIT_FLOOR, dtype=torch.int32,
                     device=pos_g.device)
    _launch("build_inv", f"asn_build_inv_{_suffix('build_inv', pos_g.dtype)}",
            [*ncells, cap, wpad, kpad] + _sec_ints(sections),
            [keep_radius * keep_radius], pos_g, sp_g, h, inv, ovf)
    return inv, ovf


def build_idx(inv, kpad):
    """idx (replaces aev_asn._build_idx_kernel)."""
    if not _route("build_idx", inv):
        return build_idx_plain(inv, kpad)
    if inv.dtype != torch.int16 or inv.dim() != 3:
        raise ValueError(f"build_idx: inv {tuple(inv.shape)} {inv.dtype}")
    nc, cap, wpad = inv.shape
    idx = torch.empty((nc, cap, kpad), dtype=torch.int16, device=inv.device)
    _launch("build_idx", "asn_build_idx_any", [nc * cap, wpad, kpad], [0.0],
            inv, idx)
    return idx


def _rep_fields(rep, sections):
    if rep is None:
        return [0, 0, 1], [0.0, 1.5], [0.0] * _MAX_S, [0.0] * _MAX_S
    env = {"smooth": 0, "cosine": 1, "none": 2}[rep.cutoff_fn]
    return ([1, env, int(rep.k_f == 1.5)], [rep.cutoff, rep.k_f],
            _pad8(rep.alpha[s] for s, _ in sections),
            _pad8(rep.zeff[s] for s, _ in sections))


def _check_idx(name, idx, sp_g):
    nc, cap = sp_g.shape
    if (idx.dim() != 3 or idx.shape[:2] != (nc, cap)
            or idx.dtype != torch.int16):
        raise ValueError(f"{name}: idx {tuple(idx.shape)} {idx.dtype}")


def _step_params(ncells, cap, kpad, spec, sections, caps, rep, dtype,
                 compact_cols=True):
    """(ip, fp) of the kernels of the step and of the radial backward
    (StepParams); `caps` None: no stage 2."""
    k = _step_consts(spec, dtype)
    if caps is None:
        caps = (0,) * spec.num_species
    a_offs, atot = _a_offsets(sections, caps)
    col0, srl = _radial_layout(spec, sections, compact_cols)
    rep_i, rep_f, alpha, zeff = _rep_fields(rep, sections)
    a_s = _pad8(a_offs[s][1] if s in a_offs else 0 for s, _ in sections)
    a_off = _pad8(a_offs[s][0] if s in a_offs else 0 for s, _ in sections)
    ip = ([*ncells, cap, _round_lane(27 * cap), kpad, k["nr"], atot, srl]
          + rep_i + _sec_ints(sections) + a_s + a_off + _pad8(col0))
    fp = ([k["rc"], k["eta"], k["mu0"], k["delta"], k["tiny"], k["pmin"],
           k["rca"], k["big"]] + rep_f + alpha + zeff)
    return ip, fp


def step_fused(pos_g, sp_g, h, idx, ncells, spec, sections, caps, rep):
    """(rad, cmp, rank2, deficit) (replaces aev_asn._step_fused_kernel)."""
    if not _route("step_fused", pos_g, sp_g, h, idx):
        return step_fused_plain(pos_g, sp_g, h, idx, ncells, spec, sections,
                                caps, rep)
    _check_grid("step_fused", ncells, pos_g, sp_g, h)
    _check_idx("step_fused", idx, sp_g)
    nc, cap = sp_g.shape
    kpad = idx.shape[-1]
    dev, dtype = pos_g.device, pos_g.dtype
    _, atot = _a_offsets(sections, caps)
    srl = len(sections) * _step_consts(spec, dtype)["nr"]
    rad = torch.empty((nc, cap, srl + 1), dtype=dtype, device=dev)
    cmp = torch.empty((nc, cap, 6, atot), dtype=dtype, device=dev)
    rank2 = torch.empty((nc, cap, kpad), dtype=torch.int16, device=dev)
    deficit = torch.full((_MAX_S,), DEFICIT_FLOOR, dtype=torch.int32,
                         device=dev)
    ip, fp = _step_params(ncells, cap, kpad, spec, sections, caps, rep, dtype)
    _launch("step_fused",
            f"asn_step_fused_{_suffix('step_fused', dtype)}", ip, fp, pos_g,
            sp_g, h, idx, rad, cmp, rank2, deficit)
    return rad, cmp, rank2, deficit


def _packed_params(name, cat, spec, caps_t, a_offs):
    """(blocks, ip, fp, table) of the packed pair kernels."""
    rows, w5 = cat.shape
    atot = w5 // 5
    blocks, _, _ = _packed_layout(spec, caps_t, a_offs)
    if len(blocks) > _MAX_BLOCKS or atot * 5 != w5 or atot > DEAD_SLOT:
        raise ValueError(f"{name}: {len(blocks)} blocks, cat {w5} wide")
    ip, fp = aev_roll._angular_params(spec, (), cat.dtype)
    pad = [0] * (_MAX_BLOCKS - len(blocks))
    ints = [rows, atot, len(blocks), ip[1]]
    # arm offsets, arm widths, same-species flag
    for col in ([b[3] for b in blocks], [b[4] for b in blocks],
                [b[5] for b in blocks], [b[6] for b in blocks],
                [int(b[7]) for b in blocks]):
        ints += col + pad
    # the f32 split power base^floor(zeta) 2^(frac log2 base), and the d of
    # a parked slot (the kernels walk the live prefix of each arm)
    zeta = fp[2]
    ints.append(math.floor(zeta))
    pmin = 1e-30 if cat.dtype == torch.float32 else 0.0
    big = 2.0 * spec.angular_cutoff + 10.0
    return (blocks, ints, fp + [pmin, zeta - math.floor(zeta), big],
            _lane_table(spec, caps_t, a_offs, cat.device))


def packed_fwd(cat, spec, caps_t, a_offs):
    """[rows, n_blocks * 32] (replaces aev_asn._packed_fwd_kernel; one
    call per occupancy tier)."""
    if not _route("packed_fwd", cat):
        return packed_fwd_plain(cat, spec, caps_t, a_offs)
    blocks, ip, fp, table = _packed_params("packed_fwd", cat, spec, caps_t,
                                           a_offs)
    out = torch.empty((cat.shape[0], len(blocks) * 32), dtype=cat.dtype,
                      device=cat.device)
    _launch("packed_fwd", f"asn_packed_fwd_{_suffix('packed_fwd', cat.dtype)}",
            ip, fp, cat, table, out)
    return out


def _check_ga(name, ga, shape, dtype):
    if ga.shape != shape or ga.dtype != dtype:
        raise ValueError(f"{name}: ga {tuple(ga.shape)} {ga.dtype}, "
                         f"expected {shape} {dtype}")


def radial_gamma(pos_g, sp_g, h, idx, ga, ncells, spec, sections, rep):
    """gr [NC, cap, 3, kpad] (replaces aev_asn._radial_gamma_only_kernel).
    The kernel writes zeros on a row with no atom (sp_g < 0) without
    reading its lanes: it equals `radial_gamma_plain` where such a row keeps
    no live lane in `idx`, as `build_idx` makes it."""
    if not _route("radial_gamma", pos_g, sp_g, h, idx, ga):
        return radial_gamma_plain(pos_g, sp_g, h, idx, ga, ncells, spec,
                                  sections, rep)
    _check_grid("radial_gamma", ncells, pos_g, sp_g, h)
    _check_idx("radial_gamma", idx, sp_g)
    nc, cap = sp_g.shape
    kpad = idx.shape[-1]
    dtype = pos_g.dtype
    ip, fp = _step_params(ncells, cap, kpad, spec, sections, None, rep,
                          dtype)
    _check_ga("radial_gamma", ga, (nc, cap, ip[8] + 1), dtype)
    gr = torch.empty((nc, cap, 3, kpad), dtype=dtype, device=pos_g.device)
    _launch("radial_gamma",
            f"asn_radial_gamma_{_suffix('radial_gamma', dtype)}", ip, fp,
            pos_g, sp_g, h, idx, ga, gr)
    return gr


def packed_bwd(cat, ga_t, spec, caps_t, a_offs):
    """[rows, 5 atot] (replaces aev_asn._packed_bwd_kernel; one call per
    occupancy tier)."""
    if not _route("packed_bwd", cat, ga_t):
        return packed_bwd_plain(cat, ga_t, spec, caps_t, a_offs)
    blocks, ip, fp, table = _packed_params("packed_bwd", cat, spec, caps_t,
                                           a_offs)
    if (ga_t.shape != (cat.shape[0], len(blocks) * 32)
            or ga_t.dtype != cat.dtype):
        raise ValueError(f"packed_bwd: ga {tuple(ga_t.shape)} {ga_t.dtype} "
                         f"for {len(blocks)} blocks, cat {tuple(cat.shape)}")
    out = torch.empty_like(cat)
    _launch("packed_bwd", f"asn_packed_bwd_{_suffix('packed_bwd', cat.dtype)}",
            ip, fp, cat, table, ga_t, out)
    return out


# shared memory a block of the card can take (H100: 227 KB)
MAX_SMEM = 227 * 1024


def _block_params(name, cat, spec, off1, a1, off2, a2, same, n_pairs,
                  pair_scalars):
    """(ip, fp) of the per-block kernels; raises on arms the rows do not
    hold and on a row whose staged slots (and, for a backward, the pair
    scalars of `n_pairs` pairs) exceed one block's shared memory."""
    rows, w5 = cat.shape
    atot = w5 // 5
    if not (atot * 5 == w5 and 0 < atot <= DEAD_SLOT and a1 >= 1
            and a2 >= 1 and 0 <= off1 and off1 + a1 <= atot and 0 <= off2
            and off2 + a2 <= atot
            and (not same or (off1, a1) == (off2, a2))):
        raise ValueError(f"{name}: arms ({off1}, {a1}), ({off2}, {a2}) "
                         f"same={same} do not fit rows {tuple(cat.shape)}")
    slots = a1 if same else a1 + a2
    need = cat.element_size() * (5 * slots + (3 * n_pairs if pair_scalars
                                              else 0))
    if need > MAX_SMEM:
        raise ValueError(f"{name}: one row needs {need} bytes of shared "
                         f"memory ({slots} slots, {n_pairs} pairs), above "
                         f"a block's {MAX_SMEM}")
    ip, fp = aev_roll._angular_params(spec, (), cat.dtype)
    return [rows, atot, off1, a1, off2, a2, int(same), ip[1]], fp


def _check_block_bwd(name, cat, ga, acc):
    if (ga.shape != (cat.shape[0], 32) or ga.dtype != cat.dtype
            or acc.shape != cat.shape or acc.dtype != cat.dtype):
        raise ValueError(f"{name}: ga {tuple(ga.shape)} {ga.dtype}, acc "
                         f"{tuple(acc.shape)} {acc.dtype} for rows "
                         f"{tuple(cat.shape)} {cat.dtype}")


def block_fwd(cat, spec, off1, a1, off2, a2, same):
    """[rows, 32] (replaces aev_asn._block_fwd_kernel; one call per block
    per occupancy tier)."""
    if not _route("block_fwd", cat):
        return block_fwd_plain(cat, spec, off1, a1, off2, a2, same)
    ip, fp = _block_params("block_fwd", cat, spec, off1, a1, off2, a2, same,
                           a1 * (a1 - 1) if same else a1 * a2, False)
    out = torch.empty((cat.shape[0], 32), dtype=cat.dtype, device=cat.device)
    _launch("block_fwd", f"asn_block_fwd_{_suffix('block_fwd', cat.dtype)}",
            ip, fp, cat, out)
    return out


def block_bwd(cat, ga, spec, off1, a1, off2, a2, same, acc):
    """`acc` with the block's slot sums added in place (replaces
    aev_asn._block_bwd_kernel; one call per block per tier)."""
    if not _route("block_bwd", cat, ga, acc):
        return block_bwd_plain(cat, ga, spec, off1, a1, off2, a2, same, acc)
    _check_block_bwd("block_bwd", cat, ga, acc)
    ip, fp = _block_params("block_bwd", cat, spec, off1, a1, off2, a2, same,
                           a1 * (a1 - 1) if same else a1 * a2, True)
    _launch("block_bwd", f"asn_block_bwd_{_suffix('block_bwd', cat.dtype)}",
            ip, fp, cat, ga, acc)
    return acc


def block_fwd_tri(cat, spec, off, a):
    """[rows, 32] (replaces aev_asn._block_fwd_tri_kernel; one call per
    same-species block per tier, for every 128-lane chunk at once)."""
    if not _route("block_fwd_tri", cat):
        return block_fwd_tri_plain(cat, spec, off, a)
    if a < 2:
        raise ValueError(f"block_fwd_tri: a block of {a} slot has no pair")
    ip, fp = _block_params("block_fwd_tri", cat, spec, off, a, off, a, True,
                           a * (a - 1) // 2, False)
    out = torch.empty((cat.shape[0], 32), dtype=cat.dtype, device=cat.device)
    _launch("block_fwd_tri",
            f"asn_block_fwd_tri_{_suffix('block_fwd_tri', cat.dtype)}", ip,
            fp, cat, out)
    return out


def block_bwd_tri(cat, ga, spec, off, a, acc):
    """`acc` with the block's slot sums added in place (replaces
    aev_asn._block_bwd_tri_kernel)."""
    if not _route("block_bwd_tri", cat, ga, acc):
        return block_bwd_tri_plain(cat, ga, spec, off, a, acc)
    if a < 2:
        raise ValueError(f"block_bwd_tri: a block of {a} slot has no pair")
    _check_block_bwd("block_bwd_tri", cat, ga, acc)
    ip, fp = _block_params("block_bwd_tri", cat, spec, off, a, off, a, True,
                           a * (a - 1) // 2, True)
    _launch("block_bwd_tri",
            f"asn_block_bwd_tri_{_suffix('block_bwd_tri', cat.dtype)}", ip,
            fp, cat, ga, acc)
    return acc


def _dh_buffers(nc, cap, dtype, dev):
    """(n_part, dh_part [n_part, 9], dh [3, 3]): one partial per block of
    8 rows, and the sum the reduce kernel writes."""
    n_part = -(-nc * cap // 8)
    return (n_part, torch.empty((n_part, 9), dtype=dtype, device=dev),
            torch.empty((3, 3), dtype=dtype, device=dev))


def _check_aligned(name, **tensors):
    """Raise unless every named tensor starts on a 16-byte boundary: the
    kernels read and write four lanes at once."""
    bad = [k for k, t in tensors.items() if t.data_ptr() % 16]
    if bad:
        raise ValueError(f"{name}: {', '.join(bad)} not 16-byte aligned "
                         "(the kernel reads four lanes at once)")


def _check_chain(name, rank2, idx, cmp, gsum, ncells, gr=None):
    nc, cap, kpad = idx.shape
    atot = cmp.shape[-1]
    dtype = cmp.dtype
    ok = (nc == ncells[0] * ncells[1] * ncells[2]
          and rank2.shape == idx.shape and rank2.dtype == torch.int16
          and idx.dtype == torch.int16 and cmp.shape == (nc, cap, 6, atot)
          and gsum.shape == (nc, cap, 5, atot) and gsum.dtype == dtype
          and (gr is None
               or (gr.shape == (nc, cap, 3, kpad) and gr.dtype == dtype))
          and atot <= DEAD_SLOT)
    if not ok:
        raise ValueError(
            f"{name}: rank2 {tuple(rank2.shape)} {rank2.dtype}, idx "
            f"{tuple(idx.shape)} {idx.dtype}, cmp {tuple(cmp.shape)}, gsum "
            f"{tuple(gsum.shape)} {gsum.dtype}"
            + ("" if gr is None else f", gr {tuple(gr.shape)} {gr.dtype}")
            + f" do not fit ncells {tuple(ncells)}")
    _check_aligned(name, rank2=rank2, idx=idx,
                   **({} if gr is None else {"gr": gr}))


def chain_sum(rank2, idx, cmp, gsum, gr, ncells, spec):
    """(gt, fcen, dh) (replaces aev_asn._chain_sum_kernel). The kernel
    writes zeros on a row with no live lane in `idx` without reading gr:
    it equals `chain_sum_plain` where gr is 0 on dead lanes (as
    `radial_gamma` writes it) and no dead lane has a slot in `rank2` (as
    `compact_asn` writes it)."""
    if not _route("chain_sum", rank2, idx, cmp, gsum, gr):
        return chain_sum_plain(rank2, idx, cmp, gsum, gr, ncells, spec)
    _check_chain("chain_sum", rank2, idx, cmp, gsum, ncells, gr)
    nc, cap, kpad = idx.shape
    dtype, dev = cmp.dtype, cmp.device
    gt = torch.empty_like(gr)
    fcen = torch.empty((nc, cap, 3), dtype=dtype, device=dev)
    n_part, dh_part, dh = _dh_buffers(nc, cap, dtype, dev)
    _launch("chain_sum", f"asn_chain_sum_{_suffix('chain_sum', dtype)}",
            [*ncells, cap, kpad, cmp.shape[-1], n_part],
            [spec.angular_cutoff + 5.0], rank2, idx, cmp, gsum, gr, gt, fcen,
            dh_part, dh)
    return gt, fcen, dh


def wing(gt, inv, idx):
    """wing [NC, 27 cap, 3] (replaces aev_asn._wing_kernel). The kernel
    scatters gt over `idx` and does not read `inv`; the plain version
    gathers through `inv` (the TPU kernel's form). The two agree bit for
    bit where build_inv reported no overflow (csrc/aev_asn.cu)."""
    if not _route("wing", gt, inv, idx):
        return wing_plain(gt, inv)
    nc, cap, _, kpad = gt.shape
    if (gt.shape[2] != 3 or idx.shape != (nc, cap, kpad)
            or idx.dtype != torch.int16 or inv.dim() != 3
            or inv.shape[:2] != (nc, cap) or inv.dtype != torch.int16
            or inv.shape[2] < 27 * cap):
        raise ValueError(f"wing: gt {tuple(gt.shape)}, inv "
                         f"{tuple(inv.shape)} {inv.dtype}, idx "
                         f"{tuple(idx.shape)} {idx.dtype}")
    _check_aligned("wing", gt=gt, idx=idx)
    out = torch.empty((nc, 27 * cap, 3), dtype=gt.dtype, device=gt.device)
    _launch("wing", f"asn_wing_{_suffix('wing', gt.dtype)}",
            [nc, cap, inv.shape[2], kpad], [0.0], gt, idx, out)
    return out


def radial_fwd_asn(pos_g, sp_g, h, idx, ncells, spec, sections, rep,
                   compact_cols=True):
    """rad [NC, cap, srl + 1] (replaces aev_asn._radial_fwd_asn_kernel)."""
    if not _route("radial_fwd_asn", pos_g, sp_g, h, idx):
        return radial_fwd_asn_plain(pos_g, sp_g, h, idx, ncells, spec,
                                    sections, rep, compact_cols)
    _check_grid("radial_fwd_asn", ncells, pos_g, sp_g, h)
    _check_idx("radial_fwd_asn", idx, sp_g)
    nc, cap = sp_g.shape
    dtype = pos_g.dtype
    ip, fp = _step_params(ncells, cap, idx.shape[-1], spec, sections, None,
                          rep, dtype, compact_cols)
    rad = torch.empty((nc, cap, ip[8] + 1), dtype=dtype, device=pos_g.device)
    _launch("radial_fwd_asn",
            f"asn_radial_fwd_asn_{_suffix('radial_fwd_asn', dtype)}", ip, fp,
            pos_g, sp_g, h, idx, rad)
    return rad


def compact_asn(pos_g, sp_g, h, idx, ncells, spec, sections, caps):
    """(cmp, rank2, deficit) (replaces aev_asn._compact_asn_kernel)."""
    if not _route("compact_asn", pos_g, sp_g, h, idx):
        return compact_asn_plain(pos_g, sp_g, h, idx, ncells, spec, sections,
                                 caps)
    _check_grid("compact_asn", ncells, pos_g, sp_g, h)
    _check_idx("compact_asn", idx, sp_g)
    nc, cap = sp_g.shape
    kpad = idx.shape[-1]
    dev, dtype = pos_g.device, pos_g.dtype
    _, atot = _a_offsets(sections, caps)
    cmp = torch.empty((nc, cap, 6, atot), dtype=dtype, device=dev)
    rank2 = torch.empty((nc, cap, kpad), dtype=torch.int16, device=dev)
    deficit = torch.full((_MAX_S,), DEFICIT_FLOOR, dtype=torch.int32,
                         device=dev)
    ip, fp = _step_params(ncells, cap, kpad, spec, sections, caps, None,
                          dtype)
    _launch("compact_asn", f"asn_compact_asn_{_suffix('compact_asn', dtype)}",
            ip, fp, pos_g, sp_g, h, idx, cmp, rank2, deficit)
    return cmp, rank2, deficit


def radial_bwd_asn(pos_g, sp_g, h, idx, ga, ncells, spec, sections, rep,
                   compact_cols=True):
    """(g, fcen, dh) (replaces aev_asn._radial_bwd_asn_kernel). Rows with
    no atom as in `radial_gamma`."""
    if not _route("radial_bwd_asn", pos_g, sp_g, h, idx, ga):
        return radial_bwd_asn_plain(pos_g, sp_g, h, idx, ga, ncells, spec,
                                    sections, rep, compact_cols)
    _check_grid("radial_bwd_asn", ncells, pos_g, sp_g, h)
    _check_idx("radial_bwd_asn", idx, sp_g)
    _check_aligned("radial_bwd_asn", idx=idx)
    nc, cap = sp_g.shape
    kpad = idx.shape[-1]
    dev, dtype = pos_g.device, pos_g.dtype
    ip, fp = _step_params(ncells, cap, kpad, spec, sections, None, rep,
                          dtype, compact_cols)
    _check_ga("radial_bwd_asn", ga, (nc, cap, ip[8] + 1), dtype)
    g = torch.empty((nc, cap, 3, kpad), dtype=dtype, device=dev)
    fcen = torch.empty((nc, cap, 3), dtype=dtype, device=dev)
    n_part, dh_part, dh = _dh_buffers(nc, cap, dtype, dev)
    _launch("radial_bwd_asn",
            f"asn_radial_bwd_asn_{_suffix('radial_bwd_asn', dtype)}",
            ip + [n_part], fp, pos_g, sp_g, h, idx, ga, g, fcen, dh_part, dh)
    return g, fcen, dh


def decompact_chain(rank2, idx, cmp, gsum, ncells, spec):
    """(gt, fcen, dh) (replaces aev_asn._decompact_chain_kernel). Equals
    `decompact_chain_plain` where no dead lane has a slot in `rank2`, as
    `compact_asn` writes it (see `chain_sum`)."""
    if not _route("decompact_chain", rank2, idx, cmp, gsum):
        return decompact_chain_plain(rank2, idx, cmp, gsum, ncells, spec)
    _check_chain("decompact_chain", rank2, idx, cmp, gsum, ncells)
    nc, cap, kpad = idx.shape
    dtype, dev = cmp.dtype, cmp.device
    gt = torch.empty((nc, cap, 3, kpad), dtype=dtype, device=dev)
    fcen = torch.empty((nc, cap, 3), dtype=dtype, device=dev)
    n_part, dh_part, dh = _dh_buffers(nc, cap, dtype, dev)
    _launch("decompact_chain",
            f"asn_decompact_chain_{_suffix('decompact_chain', dtype)}",
            [*ncells, cap, kpad, cmp.shape[-1], n_part],
            [spec.angular_cutoff + 5.0], rank2, idx, cmp, gsum, gt, fcen,
            dh_part, dh)
    return gt, fcen, dh


# ---------------------------------------------------------------------------
# Flat-row glue and the fused forward
# ---------------------------------------------------------------------------


_KERNELS = {"step": step_fused, "packed": packed_fwd,
            "gamma": radial_gamma, "packed_bwd": packed_bwd,
            "chain": chain_sum, "wing": wing, "radial": radial_fwd_asn,
            "compact": compact_asn, "radial_bwd": radial_bwd_asn,
            "decompact": decompact_chain, "block_fwd": block_fwd,
            "block_bwd": block_bwd, "block_fwd_tri": block_fwd_tri,
            "block_bwd_tri": block_bwd_tri}
_PLAIN = {"step": step_fused_plain, "packed": packed_fwd_plain,
          "radial": radial_fwd_asn_plain, "compact": compact_asn_plain,
          "block_fwd": block_fwd_plain, "block_fwd_tri": block_fwd_tri_plain}


def _tier_pad_row(atot, rca, dtype, device):
    """Dead-row value of the 5 concatenated slot fields [5 atot]."""
    vals = torch.zeros(5 * atot, dtype=dtype, device=device)
    vals[3 * atot:4 * atot] = 2.0 * rca + 10.0
    return vals


def _compact_to_flat(cmp, cell, slot, n, n_pad2, pad_row):
    """[n_pad2, 5 atot]: the packed slot fields (ux, uy, uz, d, fc) of
    the first n atoms' grid rows, in atom order, concatenated field after
    field; pad rows hold the dead-slot values."""
    atot = pad_row.shape[0] // 5
    cat = cmp[cell[:n], slot[:n]][:, :5].reshape(n, 5 * atot)
    return torch.cat([cat, pad_row.expand(n_pad2 - n, -1)])


def _gather_tier_cat(cat, row_at, valid, pad_row):
    """A tier's rows of the flat slot fields; invalid rows get the
    dead-slot values."""
    return torch.where(valid[:, None], cat[row_at], pad_row).contiguous()


def _row_counts(cat, a_offs, rca):
    """([rows, n_present] within-cutoff counts per section, species order)
    from the packed distances (live slots are <= Rca, dead ones parked at
    2 Rca + 10)."""
    atot = cat.shape[1] // 5
    d = cat[:, 3 * atot:4 * atot]
    cols = [torch.sum(d[:, off:off + a_s] < rca + 1.0, dim=1)
            for off, a_s in a_offs.values()]
    return torch.stack(cols, dim=1), tuple(a_offs)


def _tier_partition(cnts, sp_order, tiers, n):
    """Partition flat atom rows into tier regions: (pos_of [n_pad2] row in
    the concatenated tier regions, per-tier gather rows row_at [rows_t],
    per-tier valid masks, spill = rows the last tier's capacity could not
    hold). Rows that outgrow a tier's caps, or its row capacity, fall
    through to the next tier. Ranks are cumulative sums; the q-th taken
    row is found by searchsorted on the taken rows' running count."""
    n_pad2 = cnts.shape[0]
    dev = cnts.device
    real = torch.arange(n_pad2, device=dev) < n
    assigned = torch.zeros(n_pad2, dtype=torch.bool, device=dev)
    pos_of = torch.zeros(n_pad2, dtype=torch.int64, device=dev)
    row_ats, valids = [], []
    spill = torch.zeros((), dtype=torch.int64, device=dev)
    base = 0
    last = len(tiers) - 1
    for t, (caps_t, rows_t) in enumerate(tiers):
        fits = real & ~assigned
        if t != last:
            for j, s in enumerate(sp_order):
                fits = fits & (cnts[:, j] <= caps_t[s])
        f_i = fits.to(torch.int64)
        rank = torch.cumsum(f_i, 0) - f_i  # exclusive
        take = fits & (rank < rows_t)
        pos_of = torch.where(take, base + rank, pos_of)
        g_t = torch.cumsum(take.to(torch.int64), 0)
        q = torch.arange(1, rows_t + 1, device=dev)
        valid = q <= g_t[-1]
        src = torch.searchsorted(g_t, q)
        row_ats.append(torch.where(valid, src, 0))
        valids.append(valid)
        assigned = assigned | take
        if t == last:
            spill = f_i.sum() - g_t[-1]
        base += rows_t
    return pos_of, row_ats, valids, spill


def _stage_blocks(spec, caps_t, a_offs, pair_stage):
    """The per-block stage's calls for one tier, one per present
    species-pair block in `_pair_blocks` order (ascending channel, the
    compact column order): ("tri", (off, a)), ("zero", ()) for a triangle
    without a pair (a < 2), or ("block", (off1, a1, off2, a2, same)).
    Each arm is the first a_t slots of its section (stage 2 packs a
    section from its start, so they hold every neighbor of a row that fits
    the tier's caps)."""
    calls = []
    for s1, s2, a1, a2, _, same in aev_roll._pair_blocks(spec, caps_t):
        if s1 not in a_offs or s2 not in a_offs:
            continue
        off1, off2 = a_offs[s1][0], a_offs[s2][0]
        if same and pair_stage == "blocks":
            calls.append(("tri", (off1, a1)) if a1 >= 2 else ("zero", ()))
        else:
            calls.append(("block", (off1, a1, off2, a2, same)))
    return calls


def _has_pairs(spec, caps, a_offs, pair_stage):
    """Whether the stage has any output column."""
    if pair_stage == "packed":
        return _packed_layout(spec, caps, a_offs) is not None
    return bool(_stage_blocks(spec, caps, a_offs, pair_stage))


def _tier_fwd(ops, cat_t, spec, caps_t, a_offs, pair_stage):
    """[rows_t, n_blocks * 32]: one tier's columns, from the packed
    kernel or from one per-block call per block."""
    if pair_stage == "packed":
        return ops["packed"](cat_t, spec, caps_t, a_offs)
    cols = []
    for kind, args in _stage_blocks(spec, caps_t, a_offs, pair_stage):
        if kind == "zero":
            cols.append(cat_t.new_zeros((cat_t.shape[0], 32)))
        else:
            fn = ops["block_fwd_tri" if kind == "tri" else "block_fwd"]
            cols.append(fn(cat_t, spec, *args))
    return torch.cat(cols, dim=1)


def _tier_bwd(ops, cat_t, ga_t, spec, caps_t, a_offs, pair_stage):
    """[rows_t, 5 atot]: one tier's slot sums for the cotangent `ga_t` of
    its columns; the per-block calls add into one buffer in block
    order."""
    if pair_stage == "packed":
        return ops["packed_bwd"](cat_t, ga_t, spec, caps_t, a_offs)
    acc = torch.zeros_like(cat_t)
    for i, (kind, args) in enumerate(_stage_blocks(spec, caps_t, a_offs,
                                                   pair_stage)):
        if kind != "zero":
            fn = ops["block_bwd_tri" if kind == "tri" else "block_bwd"]
            fn(cat_t, ga_t[:, 32 * i:32 * (i + 1)].contiguous(), spec,
               *args, acc)
    return acc


def _angular_pair_stage(spec, sections, caps, tiers, n, cmp, deficit, cell,
                        slot, ops, pair_stage):
    """([n, n_blocks * 32] compact angular AEV, deficit, part) from the
    packed slots: flat atom rows (padded to the flat row block), optionally
    split into occupancy tiers of narrower caps, through the packed or the
    per-block pair stage (`pair_stage`); tiered, the deficit gains one
    trailing entry, the rows the last tier could not hold. `part` is what
    the backward reads again: the rows each tier's calls were given
    ("cats", with the tier layout and partition when tiered); None without
    pair blocks."""
    rca = spec.angular_cutoff
    a_offs, atot = _a_offsets(sections, caps)
    dtype, dev = cmp.dtype, cmp.device
    if not _has_pairs(spec, caps, a_offs, pair_stage):
        return cmp.new_zeros((n, 0)), deficit, None
    r = _r_flat(n)
    n_pad2 = -(-n // r) * r
    pad_row = _tier_pad_row(atot, rca, dtype, dev)
    cat = _compact_to_flat(cmp, cell, slot, n, n_pad2, pad_row)
    tiers_n = _norm_tiers(tiers, caps, r, n_pad2)
    if tiers_n is None:
        out = _tier_fwd(ops, cat, spec, caps, a_offs, pair_stage)[:n]
        return out, deficit, dict(tiers=None, cats=[cat])
    cnts, sp_order = _row_counts(cat, a_offs, rca)
    pos_of, row_ats, valids, spill = _tier_partition(cnts, sp_order,
                                                     tiers_n, n)
    cats = [_gather_tier_cat(cat, row_at, valid, pad_row)
            for row_at, valid in zip(row_ats, valids)]
    outs = [_tier_fwd(ops, cat_t, spec, caps_t, a_offs, pair_stage)
            for (caps_t, _), cat_t in zip(tiers_n, cats)]
    out = torch.cat(outs)[pos_of[:n]]
    part = dict(tiers=tiers_n, cats=cats, pos_of=pos_of, row_at=row_ats,
                valid=valids)
    return out, torch.cat([deficit, spill.to(dtype)[None]]), part


def _pad_rows(x, n_all):
    """`x` [n, ...] with zero rows appended up to n_all rows (the atoms
    beyond `n_out` carry no cotangent)."""
    if x.shape[0] == n_all:
        return x
    return torch.cat([x, x.new_zeros((n_all - x.shape[0],) + x.shape[1:])])


def _angular_gsum_grid(spec, sections, caps, n, inv_bins, g_ang, part, ops,
                       n_all=None, pair_stage="packed"):
    """[NC, cap, 5, atot]: the packed slots' cotangent sums in grid
    layout, from the angular cotangent `g_ang` [n, n_blocks * 32], over
    the same rows the forward's pair-stage calls were given (`part`);
    `n_all` binned atoms (default n), those from n on with zero sums."""
    a_offs, atot = _a_offsets(sections, caps)
    if part is None:
        gsum = g_ang.new_zeros((n, 5 * atot))
    elif part["tiers"] is None:
        cat = part["cats"][0]
        ga = torch.nn.functional.pad(g_ang, (0, 0, 0, cat.shape[0] - n))
        gsum = _tier_bwd(ops, cat, ga, spec, caps, a_offs, pair_stage)[:n]
    else:
        n_pad2 = part["pos_of"].shape[0]
        ga = torch.nn.functional.pad(g_ang, (0, 0, 0, n_pad2 - n))
        outs = []
        for (caps_t, _), row_at, valid, cat_t in zip(
                part["tiers"], part["row_at"], part["valid"], part["cats"]):
            ga_t = torch.where(valid[:, None], ga[row_at], 0.0)
            outs.append(_tier_bwd(ops, cat_t, ga_t, spec, caps_t, a_offs,
                                  pair_stage))
        gsum = torch.cat(outs)[part["pos_of"][:n]]
    gsum = aev_roll._to_grid_rows(inv_bins, _pad_rows(gsum, n_all or n), 0.0)
    return gsum.reshape(*gsum.shape[:2], 5, atot).contiguous()


def _forward(static, pos, h, inv_bins, csp_grid, cell, slot, idx, ops,
             n_out=None):
    """((radial, erep, angular, deficit), (cmp, rank2, part)): the outputs
    (rows of the first `n_out` atoms) and what the backward reads again."""
    spec, ncells, sections, caps, tiers, rep, pair_stage = static
    pos_g, sp_g = aev_roll._grid_inputs(inv_bins, pos, csp_grid)
    rad, cmp, rank2, deficit = ops["step"](pos_g, sp_g, h, idx, ncells, spec,
                                           sections, caps, rep)
    n = cell.shape[0] if n_out is None else n_out
    srl = rad.shape[-1] - 1
    rows = rad[cell[:n], slot[:n]]
    deficit = deficit[:spec.num_species].to(pos.dtype)
    angular, deficit, part = _angular_pair_stage(
        spec, sections, caps, tiers, n, cmp, deficit, cell, slot, ops,
        pair_stage)
    return (rows[:, :srl], rows[:, srl], angular, deficit), (cmp, rank2, part)


def _cotangent_grid_rows(inv_bins, g_rad, g_rep, n_all):
    """[NC, cap, srl + 1]: the radial cotangent with the repulsion
    cotangent in the last column, in grid layout."""
    ga = _pad_rows(torch.cat([g_rad, g_rep[:, None]], dim=1), n_all)
    return aev_roll._to_grid_rows(inv_bins, ga, 0.0).contiguous()


def _backward(static, pos, h, inv_bins, csp_grid, cell, slot, idx, inv, cmp,
              rank2, part, g_rad, g_rep, g_ang, ops):
    """(dpos [n, 3], dh [3, 3]) of the fused forward: the radial and
    repulsion cotangents on the compact lanes, summed with the angular
    chain before one wing gather, one fold and one dh. The cotangents may
    cover the first atoms only (`n_out`)."""
    spec, ncells, sections, caps, _, rep, pair_stage = static
    n_all = cell.shape[0]
    pos_g, sp_g = aev_roll._grid_inputs(inv_bins, pos, csp_grid)
    ga = _cotangent_grid_rows(inv_bins, g_rad, g_rep, n_all)
    gr = ops["gamma"](pos_g, sp_g, h, idx, ga, ncells, spec, sections, rep)
    gsum = _angular_gsum_grid(spec, sections, caps, g_ang.shape[0], inv_bins,
                              g_ang, part, ops, n_all, pair_stage)
    gt, fcen, dh = ops["chain"](rank2, idx, cmp, gsum, gr, ncells, spec)
    del gr
    wing_g = ops["wing"](gt, inv, idx)
    return aev_roll._fold_wing(ncells, 1, fcen, wing_g)[cell, slot], dh


class _AsnFused(torch.autograd.Function):
    """The fused forward and its explicit backward (the kernels on the
    card, their plain versions on the CPU), the spans `aev_forward` and
    `aev_backward`. The stage-2 slots, `rank2` and the rows of the packed
    calls ride from the forward to the backward."""

    @staticmethod
    def forward(ctx, pos, h, inv_bins, csp_grid, cell, slot, idx, inv,
                static, n_out):
        with phase("aev_forward"):
            out, (cmp, rank2, part) = _forward(static, pos, h, inv_bins,
                                               csp_grid, cell, slot, idx,
                                               _KERNELS, n_out)
        ctx.static = static
        ctx.save_for_backward(pos, h, inv_bins, csp_grid, cell, slot, idx,
                              inv)
        # intermediates (no output of this function): kept on the context
        ctx.residuals = (cmp, rank2, part)
        ctx.mark_non_differentiable(out[3])
        return out

    @staticmethod
    def backward(ctx, g_rad, g_rep, g_ang, _):
        with phase("aev_backward"):
            dpos, dh = _backward(ctx.static, *ctx.saved_tensors,
                                 *ctx.residuals, g_rad.contiguous(),
                                 g_rep.contiguous(), g_ang.contiguous(),
                                 _KERNELS)
        return (dpos, dh) + (None,) * 8


def _radial_forward(static, pos, h, inv_bins, csp_grid, cell, slot, idx, ops,
                    n_out=None):
    """(radial [n, srl], erep [n]): the radial channel alone."""
    spec, ncells, sections, rep, compact_cols = static
    pos_g, sp_g = aev_roll._grid_inputs(inv_bins, pos, csp_grid)
    rad = ops["radial"](pos_g, sp_g, h, idx, ncells, spec, sections, rep,
                        compact_cols)
    n = cell.shape[0] if n_out is None else n_out
    srl = rad.shape[-1] - 1
    rows = rad[cell[:n], slot[:n]]
    return rows[:, :srl], rows[:, srl]


def _radial_backward(static, pos, h, inv_bins, csp_grid, cell, slot, idx,
                     inv, g_rad, g_rep, ops):
    """(dpos [n, 3], dh [3, 3]) of the radial channel: lane cotangents,
    center force and dh from one kernel, then its own wing and fold."""
    spec, ncells, sections, rep, compact_cols = static
    pos_g, sp_g = aev_roll._grid_inputs(inv_bins, pos, csp_grid)
    ga = _cotangent_grid_rows(inv_bins, g_rad, g_rep, cell.shape[0])
    g, fcen, dh = ops["radial_bwd"](pos_g, sp_g, h, idx, ga, ncells, spec,
                                    sections, rep, compact_cols)
    wing_g = ops["wing"](g, inv, idx)
    return aev_roll._fold_wing(ncells, 1, fcen, wing_g)[cell, slot], dh


class _RadialAsn(torch.autograd.Function):
    """The radial channel and its explicit backward (the kernels on the
    card, their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, pos, h, inv_bins, csp_grid, cell, slot, idx, inv,
                static, n_out):
        ctx.static = static
        ctx.save_for_backward(pos, h, inv_bins, csp_grid, cell, slot, idx,
                              inv)
        return _radial_forward(static, pos, h, inv_bins, csp_grid, cell,
                               slot, idx, _KERNELS, n_out)

    @staticmethod
    def backward(ctx, g_rad, g_rep):
        dpos, dh = _radial_backward(ctx.static, *ctx.saved_tensors,
                                    g_rad.contiguous(), g_rep.contiguous(),
                                    _KERNELS)
        return (dpos, dh) + (None,) * 8


def _place_blocks(spec, caps, sections, angular):
    """The full torchani layout of compact angular columns: the present
    species-pair blocks (ascending offset, `present_channels`) at their
    offsets among zero blocks."""
    asub = spec.angular_sublength
    at = {ch0: i * asub for i, ch0 in enumerate(
        present_channels(spec, caps, sections))}
    zero = angular.new_zeros((angular.shape[0], asub))
    return torch.cat([angular[:, at[ch0]:at[ch0] + asub] if ch0 in at
                      else zero for ch0 in range(0, spec.angular_length,
                                                 asub)], dim=1)


def _cut_blocks(spec, caps, sections, full):
    """The compact columns of a full-layout tensor: the present blocks cut
    out again (the inverse of `_place_blocks`)."""
    asub = spec.angular_sublength
    return torch.cat([full[:, ch0:ch0 + asub] for ch0 in
                      present_channels(spec, caps, sections)]
                     or [full[:, :0]], dim=1)


def _angular_forward(static, pos, h, inv_bins, csp_grid, cell, slot, idx,
                     ops, n_out=None):
    """((angular, deficit), (cmp, rank2, part)): the angular channel alone
    and what its backward reads again."""
    spec, ncells, sections, caps, tiers, compact_cols, pair_stage = static
    pos_g, sp_g = aev_roll._grid_inputs(inv_bins, pos, csp_grid)
    cmp, rank2, deficit = ops["compact"](pos_g, sp_g, h, idx, ncells, spec,
                                         sections, caps)
    n = cell.shape[0] if n_out is None else n_out
    deficit = deficit[:spec.num_species].to(pos.dtype)
    angular, deficit, part = _angular_pair_stage(
        spec, sections, caps, tiers, n, cmp, deficit, cell, slot, ops,
        pair_stage)
    if not compact_cols:
        angular = _place_blocks(spec, caps, sections, angular)
    return (angular, deficit), (cmp, rank2, part)


def _angular_backward(static, inv_bins, cell, slot, idx, inv, cmp, rank2,
                      part, g_ang, ops):
    """(dpos [n, 3], dh [3, 3]) of the angular channel from the forward's
    slots, `rank2` and packed rows: it reads no positions."""
    spec, ncells, sections, caps, _, compact_cols, pair_stage = static
    if not compact_cols:
        g_ang = _cut_blocks(spec, caps, sections, g_ang)
    gsum = _angular_gsum_grid(spec, sections, caps, g_ang.shape[0], inv_bins,
                              g_ang.contiguous(), part, ops, cell.shape[0],
                              pair_stage)
    gt, fcen, dh = ops["decompact"](rank2, idx, cmp, gsum, ncells, spec)
    wing_g = ops["wing"](gt, inv, idx)
    return aev_roll._fold_wing(ncells, 1, fcen, wing_g)[cell, slot], dh


class _AngularAsn(torch.autograd.Function):
    """The angular channel and its explicit backward. The stage-2 slots,
    `rank2` and the rows of the packed calls ride from the forward to the
    backward, as in `_AsnFused`."""

    @staticmethod
    def forward(ctx, pos, h, inv_bins, csp_grid, cell, slot, idx, inv,
                static, n_out):
        out, (cmp, rank2, part) = _angular_forward(
            static, pos, h, inv_bins, csp_grid, cell, slot, idx, _KERNELS,
            n_out)
        ctx.static = static
        ctx.save_for_backward(inv_bins, cell, slot, idx, inv)
        ctx.residuals = (cmp, rank2, part)
        ctx.mark_non_differentiable(out[1])
        return out

    @staticmethod
    def backward(ctx, g_ang, _):
        dpos, dh = _angular_backward(ctx.static, *ctx.saved_tensors,
                                     *ctx.residuals, g_ang, _KERNELS)
        return (dpos, dh) + (None,) * 8


def build_assignment(grid, bins, pos, box, sections, kpad, keep_radius):
    """Assignment over the grid's 27-bin window for lanes within
    `keep_radius`. `sections`: ((species, k_s), ...) of the present
    species; compact lanes [off_s, off_s + k_s) hold species s, ranked by
    window lane. `kpad`: a multiple of 128 with sum(k_s) <= kpad - 1 (the
    last lane is the inverse map's dead lane). Tables are int16."""
    _, k_total = _sec_offsets(sections)
    if kpad % _LANE or k_total > kpad - 1:
        raise ValueError(f"kpad {kpad} must be a multiple of {_LANE} above "
                         f"the section total {k_total}")
    wpad = _round_lane(27 * grid.cap)
    if wpad >= 2 ** 15:
        raise ValueError(f"window of {wpad} lanes does not fit int16")
    with torch.no_grad():
        pos_g, sp_g = aev_roll._grid_inputs(bins.inv, pos, bins.species_grid)
        inv, ovf = build_inv(pos_g, sp_g, box.h.contiguous(), grid.ncells,
                             sections, kpad, keep_radius)
        idx = build_idx(inv, kpad)
    n_sp = 1 + max(s for s, _ in sections)
    ovf_sec = ovf[:n_sp].to(pos.dtype)
    return Assignment(idx=idx, inv=inv, ovf=ovf_sec.max(), ovf_sec=ovf_sec)


def _tiers_static(tiers):
    return (tuple((tuple(int(c) for c in caps_t), int(rw))
                  for caps_t, rw in tiers) if tiers else None)


def _check_n_out(n_out, bins):
    n = bins.cell.shape[0]
    if n_out is not None and not 0 < n_out <= n:
        raise ValueError(f"n_out {n_out} outside (0, {n}]")
    return None if n_out == n else n_out


def aev_asn_fused(aev_spec, grid, bins, asn, pos, box, sections, caps,
                  tiers=None, repulsion=None, n_out=None, plain=False,
                  pair_stage="packed"):
    """(radial [n, S_present*16], erep [n] Hartree, angular [n, blocks*32],
    deficit): both AEV channels in compact columns (present sections;
    present species-pair blocks, see present_channels) through one fused
    forward over the frozen assignment `asn`.

    `caps`: per-step per-species angular capacities; deficit[s] > 0 means
    a cap truncated real neighbors this step. `tiers` ((caps_t, rows_t),
    ..., last at the full caps): occupancy tiers of the pair stage; the
    deficit then gains a trailing entry, the rows the last tier could not
    hold. `n_out`: AEV rows, and pair-block work, for the first n_out
    binned atoms only (a domain's owned atoms); the others still take
    their neighbor-role force through the gradient. `pair_stage`: one of
    PAIR_STAGES, the angular pair stage's kernels (the same function in
    another summation order); the backward runs the same stage.

    Differentiable with respect to `pos` and `box.h`: one autograd.Function
    whose backward is the backward kernels on the card and their plain
    versions on the CPU. `plain=True` runs the plain forwards
    whatever the device and leaves the gradient to autograd through them
    (the reference the kernels and the explicit backward are held
    against)."""
    _check_stage(pair_stage)
    static = (aev_spec, tuple(grid.ncells), tuple(sections), tuple(caps),
              _tiers_static(tiers), repulsion, pair_stage)
    n_out = _check_n_out(n_out, bins)
    args = (pos, box.h.contiguous(), bins.inv, bins.species_grid, bins.cell,
            bins.slot, asn.idx)
    if plain:
        return _forward(static, *args, _PLAIN, n_out)[0]
    return _AsnFused.apply(*args, asn.inv, static, n_out)


def radial_aev_asn(aev_spec, grid, bins, asn, pos, box, sections,
                   repulsion=None, n_out=None, compact_cols=False,
                   plain=False):
    """(radial [n_out, S*16], erep [n_out] Hartree): the radial channel
    alone over the frozen assignment `asn`, with the XTB repulsion energy
    of each atom where `repulsion` is given (else zeros).

    `compact_cols`: only the present sections' 16 columns each, in
    `sections` order, as `aev_asn_fused` gives them; by default the full
    layout s*16 + k over all species of the spec, zeros for the species no
    section holds. The cotangent arrives in the same layout. `n_out`,
    `plain`: as in `aev_asn_fused`. Differentiable with respect to `pos`
    and `box.h` (explicit backward: `radial_bwd_asn`, `wing`, the fold)."""
    static = (aev_spec, tuple(grid.ncells), tuple(sections), repulsion,
              bool(compact_cols))
    n_out = _check_n_out(n_out, bins)
    args = (pos, box.h.contiguous(), bins.inv, bins.species_grid, bins.cell,
            bins.slot, asn.idx)
    if plain:
        return _radial_forward(static, *args, _PLAIN, n_out)
    return _RadialAsn.apply(*args, asn.inv, static, n_out)


def angular_aev_asn(aev_spec, grid, bins, asn, pos, box, sections, caps,
                    tiers=None, n_out=None, compact_cols=False, plain=False,
                    pair_stage="packed"):
    """(angular [n_out, angular_length], deficit): the angular channel
    alone over the frozen assignment `asn` (stage-2 compaction, then the
    pair stage `pair_stage`, tiered where `tiers` is given).

    `compact_cols`: only the present species-pair blocks' 32 columns each,
    ascending torchani offset (`present_channels`), as `aev_asn_fused`
    gives them; by default the full torchani layout with zero blocks for
    absent pairs. The cotangent arrives in the same layout. `caps`,
    `tiers`, the deficit, `n_out`, `plain` and `pair_stage`: as in
    `aev_asn_fused`. Differentiable with respect to `pos` and `box.h`
    (explicit backward: `packed_bwd` or the per-block backwards,
    `decompact_chain`, `wing`, the fold)."""
    _check_stage(pair_stage)
    static = (aev_spec, tuple(grid.ncells), tuple(sections), tuple(caps),
              _tiers_static(tiers), bool(compact_cols), pair_stage)
    n_out = _check_n_out(n_out, bins)
    args = (pos, box.h.contiguous(), bins.inv, bins.species_grid, bins.cell,
            bins.slot, asn.idx)
    if plain:
        return _angular_forward(static, *args, _PLAIN, n_out)[0]
    return _AngularAsn.apply(*args, asn.inv, static, n_out)
