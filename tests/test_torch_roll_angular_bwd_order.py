"""The arithmetic of the roll engine's angular_bwd kernel (lammps_ani_torch/
csrc/aev_roll.cu, `angular_bwd_kernel`), transcribed in torch and numpy and
held against the plain version and the JAX package's `_angular_bwd_kernel`
(through `_angular_bwd_impl`, interpret mode). chip_smoke.py holds the
kernel itself against the plain version on the card.

The kernel stages each bin's 27-bin window once; a warp takes the bin's
centers one at a time:
  * compaction by ballot: 32 window lanes at a time, one distance a lane,
    each species' in-Rca lanes ranked by popcount with a carry, the first
    caps[s] kept in ascending lane order;
  * per species-pair block (torchani triu order), pass 1 gives each slot
    pair (the triangle enumerated by a float square root and an integer
    correction, the rectangle row by row) its three scalars (dcos,
    drmean / 2, dfc12); pass 2 gives each slot to one lane, which walks its
    partners in index order, adding dcos times the partner's unit vector,
    drmean / 2 and dfc12 times the partner's fc to the slot's five sums;
  * each slot's sums chain to its lane cotangent; fcen is their sum;
then the wing adds the centers' lane cotangents center after center, and
the bin's dh partial is the sum over offsets of S_m times the offset's
wing sums.

System: WATER30 x 2^3 (240 atoms, 16 A box), a 3 x 3 x 3 fine grid (bin
side >= 4.5 A) at cap 16; angular caps H 20, O 12; a seeded cotangent;
f64. Limits: against the plain version 1e-12 of each output's largest
magnitude (dh: of the sum of its terms' magnitudes); against JAX, the
folded dpos and dh within 1e-10 of theirs.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ani_tpu.models import aev as jaev
from lammps_ani_tpu.ops import aev_pallas as jap
from lammps_ani_tpu.ops import cell_roll as jcr
from lammps_ani_tpu.ops import neighbors as jnb
from lammps_ani_torch.models import aev as taev
from lammps_ani_torch.ops import aev_roll as tar
from lammps_ani_torch.ops import cell_roll as tcr
from lammps_ani_torch.ops import neighbors as tnb

from .test_torch_build_inv_order import stage_window, window_tab
from .test_torch_neighbors import boxes, water_system

PRESENT = (0, 3)
CAPS = (20, 0, 0, 12, 0, 0, 0)
CAP = 16

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: with several test processes on one machine, each
    with a thread per core, the threads wait on one another at every
    operation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def compact(cst, caps, present, pos_g, win_p, win_s):
    """Slot lanes [NC, cap, atot] (window lane, or -1 for an unfilled
    slot) by the kernel's ballot: 32 window lanes at a time, a carry per
    species; and the in-Rca counts per species {s: [NC, cap]}."""
    nc, cap = pos_g.shape[:2]
    w_total = win_s.shape[1]
    slot0, atot = {}, 0
    for s in range(len(caps)):
        slot0[s] = atot
        atot += caps[s]
    lanes_out = torch.full((nc, cap, atot), -1, dtype=torch.int64)
    carry = {s: torch.zeros((nc, cap), dtype=torch.int64) for s in present}
    self_lane = 13 * cap + torch.arange(cap)
    for base in range(0, w_total, 32):
        lanes = torch.arange(base, min(base + 32, w_total))
        d = pos_g[:, :, None, :] - win_p[:, None, lanes, :]
        dist = torch.sqrt(torch.clamp((d * d).sum(-1), min=1e-12))
        sw = win_s[:, None, lanes].expand(-1, cap, -1)
        ok = ((sw >= 0) & (dist <= cst["rca"])
              & (lanes[None, None, :] != self_lane[None, :, None]))
        for s in present:
            bal = ok & (sw == s)
            rank = carry[s][..., None] + torch.cumsum(
                bal.to(torch.int64), -1) - bal.to(torch.int64)
            keep = bal & (rank < caps[s])
            idx = torch.nonzero(keep, as_tuple=True)
            lanes_out[idx[0], idx[1], slot0[s] + rank[keep]] = lanes[idx[2]]
            carry[s] += bal.sum(-1)
    return lanes_out, carry, slot0


def tri_pair(t, a1):
    """Slot pair (j, k), j < k, of pair t of an a1 x a1 strict upper
    triangle row by row, as block_pair<kTri> finds it: counted from the
    end, the rows hold 1, 2, 3, ... pairs; a float square root and an
    integer correction."""
    r = a1 * (a1 - 1) // 2 - 1 - t
    jr = int((np.sqrt(np.float32(8.0 * r + 1.0)) - np.float32(1.0))
             * np.float32(0.5))
    while (jr + 1) * (jr + 2) // 2 <= r:
        jr += 1
    while jr * (jr + 1) // 2 > r:
        jr -= 1
    j = a1 - 2 - jr
    return j, t - tri_start(j, a1) + j + 1


def tri_start(j, a):
    return j * (2 * a - j - 1) // 2


def pair_scalars(cst, u1, u2, d1, d2, fc1, fc2, gb):
    """(dcos, drmean / 2, dfc12) [q] of pairs with arms (u [q, 3], d, fc)
    for the block's column cotangents gb [32] (pair_cotangents)."""
    pt = tar._pair_terms_core(cst, u1, u2, d1, d2, fc1, fc2)
    nsz = len(cst["cos_m"])
    df2 = [torch.zeros_like(d1) for _ in pt["e_j"]]
    dcos = torch.zeros_like(d1)
    for m in range(nsz):
        df1 = torch.zeros_like(d1)
        for j, e in enumerate(pt["e_j"]):
            g = gb[j * nsz + m]
            df1 = df1 + g * (pt["fc12"] * e)
            df2[j] = df2[j] + g * pt["f1_m"][m]
        dbase = df1 * (cst["zeta"] / pt["base_m"][m]) * pt["f1_m"][m]
        dcos = dcos + dbase * 0.5 * (
            cst["cos_m"][m] - pt["c95"] / pt["sv"] * cst["sin_m"][m]) * 0.95
    drmean = torch.zeros_like(d1)
    dfc12 = torch.zeros_like(d1)
    for j, e in enumerate(pt["e_j"]):
        drmean = drmean + df2[j] * pt["fc12"] * e * (-2.0 * cst["eta"]) * (
            pt["x2"] - j * cst["delta"])
        dfc12 = dfc12 + df2[j] * e
    drmean = torch.where(d1 + d2 <= 2.0 * (cst["rca"] + 1.0), drmean, 0.0)
    return dcos, 0.5 * drmean, dfc12


def emulate_angular_bwd(pos_g, sp_g, h, ncells, spec, caps, present, ga_g):
    """(fcen, wing, dh, slot lanes) as the kernel computes them."""
    cst = tar.angular_consts(spec, pos_g.dtype)
    nc, cap = sp_g.shape
    w_total = 27 * cap
    rca, big = cst["rca"], 2.0 * cst["rca"] + 10.0
    win_p, win_s = stage_window(pos_g, sp_g, h, ncells, present)
    lanes, carry, slot0 = compact(cst, caps, present, pos_g, win_p, win_s)
    atot = lanes.shape[-1]
    # slot fields [NC, cap, atot]: u, d_safe, fc, dfc, lane (-1: none)
    filled = lanes >= 0
    cand = torch.gather(win_p, 1, torch.clamp(lanes, min=0).reshape(
        nc, cap * atot, 1).expand(-1, -1, 3)).reshape(nc, cap, atot, 3)
    dvec = pos_g[:, :, None, :] - cand
    dist = torch.sqrt(torch.clamp((dvec * dvec).sum(-1), min=1e-12))
    valid = filled & (dist > 1e-6)
    d_safe = torch.where(valid, dist, big)
    u = dvec / d_safe[..., None]
    arg = dist * (math.pi / rca)
    fc = torch.where(valid, 0.5 * torch.cos(arg) + 0.5, 0.0)
    dfc = torch.where(valid, (-0.5 * math.pi / rca) * torch.sin(arg), 0.0)
    slot_lane = torch.where(valid, lanes, -1)
    blocks = tar._pair_blocks(spec, caps)
    fcen = torch.zeros((nc, cap, 3), dtype=pos_g.dtype)
    res = torch.zeros((nc, cap, atot, 3), dtype=pos_g.dtype)
    for c in range(nc):
        for a in range(cap):
            if sp_g[c, a] < 0:
                continue
            o = np.zeros((5, atot))
            s_u, s_d, s_fc = u[c, a], d_safe[c, a], fc[c, a]
            for s1, s2, _, _, ch0, same in blocks:
                n1 = min(int(carry[s1][c, a]), caps[s1])
                n2 = min(int(carry[s2][c, a]), caps[s2])
                q = n1 * (n1 - 1) // 2 if same else n1 * n2
                if q == 0:
                    continue
                off1, off2 = slot0[s1], slot0[s2]
                gb = 2.0 * ga_g[c, a, ch0:ch0 + 32]
                # pass 1: each pair's scalars
                pairs = [tri_pair(t, n1) if same else divmod(t, n2)
                         for t in range(q)]
                i1 = torch.tensor([off1 + j for j, _ in pairs])
                i2 = torch.tensor([off2 + k for _, k in pairs])
                pb = [x.numpy() for x in pair_scalars(
                    cst, s_u[i1], s_u[i2], s_d[i1], s_d[i2], s_fc[i1],
                    s_fc[i2], gb)]
                uu, ff = s_u.numpy(), s_fc.numpy()

                def add(g, t, partner):
                    g[0:3] += pb[0][t] * uu[partner]
                    g[3] += pb[1][t]
                    g[4] += pb[2][t] * ff[partner]

                # pass 2: each slot walks its partners in index order
                if same:
                    for j in range(n1):
                        g = np.zeros(5)
                        t_lo, t_hi = j - 1, tri_start(j, n1)
                        for k in range(n1):
                            if k == j:
                                continue
                            add(g, t_lo if k < j else t_hi, off1 + k)
                            if k < j:
                                t_lo += n1 - 2 - k
                            else:
                                t_hi += 1
                        o[:, off1 + j] += g
                else:
                    for i in range(n1):
                        g = np.zeros(5)
                        for k in range(n2):
                            add(g, i * n2 + k, off2 + k)
                        o[:, off1 + i] += g
                    for i in range(n2):
                        g = np.zeros(5)
                        for j in range(n1):
                            add(g, j * n2 + i, off1 + j)
                        o[:, off2 + i] += g
            # slot sums -> lane cotangents
            for qs in range(atot):
                if slot_lane[c, a, qs] < 0:
                    continue
                inv = 1.0 / float(s_d[qs])
                uq = s_u[qs].numpy()
                gu = o[0:3, qs]
                g_cd = (o[3, qs] + o[4, qs] * float(dfc[c, a, qs])
                        - float(gu @ uq) * inv)
                res[c, a, qs] = torch.from_numpy(gu * inv + g_cd * uq)
            fcen[c, a] = res[c, a].sum(0)
    # the wing, center after center; dh from per-offset sums
    wing = torch.zeros((nc, w_total, 3), dtype=pos_g.dtype)
    for a in range(cap):
        for qs in range(atot):
            w = slot_lane[:, a, qs]
            live = w >= 0
            wing[live, w[live]] -= res[live, a, qs]
    _, shift = window_tab(ncells, cap)
    osum = wing.reshape(nc, 27, cap, 3).sum(2)
    dh = torch.einsum("nom,noc->mc", shift.to(wing.dtype), osum)
    return fcen, wing, dh, lanes


@pytest.fixture(scope="module")
def case():
    species, pos, h, origin, _ = water_system(2)
    jbox, tbox = boxes(h, origin)
    jpos = jnb.wrap_positions(jnp.asarray(pos, jnp.float64), jbox)
    tpos = tnb.wrap_positions(torch.tensor(pos, dtype=torch.float64), tbox)
    jgrid = jcr.RollGrid.for_box(h, 4.5, CAP)
    tgrid = tcr.RollGrid.for_box(h, 4.5, CAP)
    jb = jcr.build_bins(jgrid, jpos, jnp.asarray(species), jbox)
    tb = tcr.build_bins(tgrid, tpos, torch.tensor(species), tbox)
    assert int(tb.count_max) <= CAP
    ga = np.random.default_rng(5).standard_normal((len(species), 896))
    dpos_j, dh_j = jap._angular_bwd_impl(
        jaev.ani2x_aev_spec(), jgrid, CAPS, PRESENT, True, jpos, jbox.h,
        jb.inv, jb.species_grid, jb.cell, jb.slot, jnp.asarray(ga))
    spec = taev.ani2x_aev_spec()
    pos_g, sp_g = tar._grid_inputs(tb.inv, tpos, tb.species_grid)
    ga_g = tar._to_grid_rows(tb.inv, torch.tensor(ga), 0.0).contiguous()
    args = (pos_g, sp_g, tbox.h.contiguous(), tgrid.ncells, spec, CAPS,
            PRESENT, ga_g)
    cst = tar.angular_consts(spec, torch.float64)
    cp, cs = tar._candidates(tgrid.ncells, pos_g, sp_g, tbox.h, 1)
    slots = tar._angular_slots(CAPS, PRESENT, pos_g, cp, cs, cst)[0]
    return dict(emulated=emulate_angular_bwd(*args),
                plain=tar.angular_bwd_plain(*args), slots=slots,
                jax=(np.asarray(dpos_j), np.asarray(dh_j)), bins=tb,
                grid=tgrid, w=cp.shape[1])


def test_ballot_compaction_gives_the_plain_slots(case):
    """The slots come out in compact_center's order: slot i of species s
    holds the i-th in-Rca lane of species s in ascending lane order."""
    lanes = case["emulated"][3]
    off = 0
    for s, c in enumerate(CAPS):
        if not c:
            continue
        ref = case["slots"][s]["lane"]
        ref = torch.where(ref < case["w"], ref, -1)
        assert torch.equal(lanes[..., off:off + c], ref)
        assert int((ref >= 0).sum()) > 0
        off += c


@pytest.mark.parametrize("i,label", [(0, "fcen"), (1, "wing"), (2, "dh")])
def test_two_pass_matches_plain(case, i, label):
    got, ref = case["emulated"][i], case["plain"][i]
    if label == "dh":
        sh = tar._wrap_shift_tables(case["grid"].ncells, 1, ref.dtype,
                                    ref.device).abs()
        nc = sh.shape[0]
        s_lane = sh[:, :, None, :].expand(nc, 27, CAP, 3).reshape(nc, -1, 3)
        scale = float(torch.einsum("nwm,nwc->mc", s_lane,
                                   case["plain"][1].abs()).max())
    else:
        scale = float(ref.abs().max())
    assert scale > 0
    assert float((got - ref).abs().max()) <= 1e-12 * scale


def test_two_pass_matches_jax(case):
    """The folded dpos and dh against the JAX kernel's."""
    fcen, wing, dh, _ = case["emulated"]
    b = case["bins"]
    dpos = tar._fold_wing(case["grid"].ncells, 1, fcen, wing)[b.cell, b.slot]
    dpos_j, dh_j = case["jax"]
    scale = np.abs(dpos_j).max()
    assert np.abs(dpos.numpy() - dpos_j).max() <= 1e-10 * scale
    assert np.abs(dh.numpy() - dh_j).max() <= 1e-10 * np.abs(dh_j).max()
