"""The arithmetic and order of the roll engine's radial_bwd kernel
(lammps_ani_torch/csrc/aev_roll.cu, `radial_bwd_kernel`), transcribed in
torch and held against the plain version and the JAX package's
`_radial_bwd_kernel` (through `_radial_bwd_impl`, interpret mode).
chip_smoke.py holds the kernel itself against the plain version on the
card.

The kernel takes one bin per block and the shell-s window one x-plane at a
time (P = (2s + 1)^2 offsets): it stages the plane's lanes of present
species compacted in lane order; the bin's real centers go in rounds of
`nw`, one a warp, in slot order; a warp tests the compacted lanes 32 at a
time, packs the lanes within Rcr (self excluded) in lane order, and takes
each pair once, on one lane: gamma = sum_k ga[s*NR + k] 0.25 e_k (dfc - 2
eta x_k fc), g = (gamma / d) (center - candidate). The lane adds g to its
fcen sums (then a warp sum, added to the center's fcen plane after plane)
and puts it in the warp's store of K pairs. Each warp then owns a range of
the plane's lanes and subtracts the stores in warp order, which is center
order; a round whose store overflowed runs again one center after the
other, each subtracting its pairs itself. So every wing entry is
((0 - g_c0) - g_c1) - ... in slot order of the centers, whatever nw and K
are. dh is the sum over offsets of S_m times the offset's wing sums; an
interior bin (every shift 0) writes 0.

In f32 the Gaussians are ex2(geta xk^2) (geta = -eta log2 e, ex2 taken
exactly here), the cutoff's cosine and sine the hardware's (applied at
their worst-case error 2^-21.4) and gamma / d is __fdividef's a x (1 / b).

System: WATER30 x 3^3 (810 atoms, 24 A box), the roll engine's fine grid
(bin side >= (Rcr + skin) / 2 = 3.55 A: 6 x 6 x 6 bins, 8 interior for the
shell-2 window) at cap 12, a seeded cotangent. Limits: f64 against the
plain version 1e-12 of each output's largest magnitude (dh: of the sum of
its terms' magnitudes); against JAX, the folded dpos and dh within 1e-10
of theirs; f32 within 0.25 of chip_smoke's gate (5e-6 + 1e-5 x the
largest magnitude) of the plain f32 version.
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

from .test_torch_neighbors import boxes, water_system

PRESENT = (0, 3)
CAP = 12
SIDE = 3.55
SHELL = 2
LOG2E = 1.4426950408889634
HW_TRIG_ERR = 2.0 ** -21.41  # __cosf / __sinf on [-pi, pi] (CUDA guide)


def gate(scale):
    return 5e-6 + 1e-5 * scale


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def window_tab(ncells, cap, shell):
    """(first grid slot [NC, n_off], wrap shift [NC, n_off, 3]) of each
    bin's shell-`shell` window offsets, x outermost (the kernel's tab)."""
    nx, ny, nz = ncells
    cell = torch.arange(nx * ny * nz)
    idx = (cell // (ny * nz), (cell // nz) % ny, cell % nz)
    base, shift = [], []
    for off in tar._shell_offsets(shell):
        j = [i + int(o) for i, o in zip(idx, off)]
        s = [(jj >= n).long() - (jj < 0).long() for jj, n in zip(j, ncells)]
        j = [jj - ss * n for jj, ss, n in zip(j, s, ncells)]
        base.append(((j[0] * ny + j[1]) * nz + j[2]) * cap)
        shift.append(torch.stack(s, -1))
    return torch.stack(base, 1), torch.stack(shift, 1)


def staged_window(pos_g, sp_g, h, ncells, shell, present):
    """(positions [NC, W, 3], species [NC, W], shift [NC, n_off, 3]) of the
    staged window: owner + sx h0, then + sy h1, then + sz h2; species -1
    where not present."""
    nc, cap = sp_g.shape
    base, shift = window_tab(ncells, cap, shell)
    n_off = base.shape[1]
    w = torch.arange(n_off * cap)
    o = w // cap
    q = base[:, o] + (w - o * cap)
    p = pos_g.reshape(-1, 3)[q]
    sh = shift[:, o]
    for m in range(3):
        s_m = sh[..., m]
        p = torch.where((s_m != 0)[..., None],
                        p + s_m[..., None].to(p.dtype) * h[m], p)
    ws = sp_g.reshape(-1)[q].long()
    kept = torch.zeros_like(ws, dtype=torch.bool)
    for s in present:
        kept |= ws == s
    return p, torch.where(kept, ws, -1), shift


def warp_sum(v):
    """The butterfly of `warp_sum` on [32, ...] lane values: lane 0's sum."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ o]
    return v[0]


def lane_sums(vals):
    """vals [q, ...] on lane t mod 32, each lane adding in order, then the
    warp sum."""
    acc = vals.new_zeros((32,) + tuple(vals.shape[1:]))
    for r0 in range(0, vals.shape[0], 32):
        blk = vals[r0:r0 + 32]
        acc[:blk.shape[0]] = acc[:blk.shape[0]] + blk
    return warp_sum(acc)


def pair_g(dvec, d, ga_sp, cst, trig_err):
    """[q, 3] g of q pairs (center - candidate dvec, distance d, the
    center's cotangents of the candidate's species ga_sp [q, NR])."""
    rc, eta, mu0, delta, nr = cst
    dtype = d.dtype
    f32 = dtype == torch.float32

    def c(v):
        return torch.tensor(v, dtype=dtype)

    arg = d * c(math.pi / rc)
    if f32:
        cos = (torch.cos(arg.double()) + trig_err).to(dtype)
        sin = (torch.sin(arg.double()) - trig_err).to(dtype)
    else:
        cos, sin = torch.cos(arg), torch.sin(arg)
    fc = c(0.5) * cos + c(0.5)
    dfc = c(-0.5 * math.pi / rc) * sin
    x = d - c(mu0)
    geta = c(-eta * LOG2E) if f32 else c(-eta)
    two_eta = c(2.0) * c(eta)
    gamma = torch.zeros_like(d)
    for k in range(nr):
        xk = x - c(float(k)) * c(delta)
        y = geta * xk * xk
        e = torch.exp2(y.double()).to(dtype) if f32 else torch.exp(y)
        gamma = gamma + ga_sp[:, k] * (c(0.25) * e
                                       * (dfc - two_eta * xk * fc))
    gd = gamma * (1.0 / d.double()).to(dtype) if f32 else gamma / d
    return gd[:, None] * dvec


def emulate_radial_bwd(pos_g, sp_g, h, ncells, shell, spec, present, ga_g,
                       nw=8, store=128, trig_err=0.0):
    """(fcen, wing, dh, overflowed rounds) as the kernel computes them,
    with `nw` warps a block and stores of `store` pairs."""
    cst = tar.radial_consts(spec)
    rc, nr = cst[0], cst[4]
    dtype = pos_g.dtype
    nc, cap = sp_g.shape
    ns = 2 * shell + 1
    P, n_off = ns * ns, ns ** 3
    pl = P * cap
    self_off = (n_off - 1) // 2
    win_p, win_s, shift = staged_window(pos_g, sp_g, h, ncells, shell,
                                        present)
    fcen = torch.zeros((nc, cap, 3), dtype=dtype)
    wing = torch.zeros((nc, n_off * cap, 3), dtype=dtype)
    dh_part = torch.zeros((nc, 9), dtype=dtype)
    rc2_hi = float(torch.tensor(rc, dtype=dtype)) ** 2 * (1 + 2.0 ** -20)
    overflowed = 0
    for cell in range(nc):
        ctr = [a for a in range(cap) if sp_g[cell, a] >= 0]
        osum = torch.zeros((n_off, 3), dtype=dtype)
        for plane in range(ns):
            w0 = plane * pl
            lanes = torch.arange(w0, w0 + pl)
            kept = lanes[win_s[cell, w0:w0 + pl] >= 0]  # lane order
            wing_p = torch.zeros((pl, 3), dtype=dtype)
            for r0 in range(0, len(ctr), nw):
                stores, over = [], False
                for a in ctr[r0:r0 + nw]:
                    dvec = pos_g[cell, a] - win_p[cell, kept]
                    d2 = (dvec * dvec).sum(-1)
                    d = torch.sqrt(torch.clamp(d2, min=1e-12))
                    m = ((kept != self_off * cap + a) & (d2 <= rc2_hi)
                         & (d <= rc))
                    sp_w = win_s[cell, kept[m]]
                    ga_sp = ga_g[cell, a].reshape(-1, nr)[sp_w]
                    g = pair_g(dvec[m], d[m], ga_sp, cst, trig_err)
                    fcen[cell, a] += lane_sums(g)
                    stores.append((kept[m] - w0, g))
                    over |= g.shape[0] > store
                # the stores in warp order (center order); an overflowed
                # round: each center after the other, the same order
                overflowed += over
                for lw, g in stores:
                    # a center's pairs name distinct lanes
                    wing_p[lw] = wing_p[lw] - g
            wing[cell, w0:w0 + pl] = wing_p
            osum[plane * P:(plane + 1) * P] = torch.stack([
                warp_sum(torch.nn.functional.pad(
                    wing_p.reshape(P, cap, 3)[o], (0, 0, 0, 32 - cap)))
                for o in range(P)])
        if bool((shift[cell] != 0).any()):
            for i in range(9):
                m_, c_ = divmod(i, 3)
                acc = torch.zeros((), dtype=dtype)
                for o in range(n_off):
                    sm = int(shift[cell, o, m_])
                    if sm:
                        acc = acc + sm * osum[o, c_]
                dh_part[cell, i] = acc
    return fcen, wing, dh_part, overflowed


def dh_reduce(dh_part):
    """dh_reduce_kernel's order is not transcribed: the partials' sum."""
    return dh_part.sum(0).reshape(3, 3)


def dh_scale(ncells, wing):
    sh = tar._wrap_shift_tables(ncells, SHELL, wing.dtype, wing.device).abs()
    nc = sh.shape[0]
    s_lane = sh[:, :, None, :].expand(nc, 125, CAP, 3).reshape(nc, -1, 3)
    return float(torch.einsum("nwm,nwc->mc", s_lane, wing.abs()).max())


@pytest.fixture(scope="module")
def case():
    species, pos, h, origin, _ = water_system(3)
    jbox, tbox = boxes(h, origin)
    jpos = jnb.wrap_positions(jnp.asarray(pos, jnp.float64), jbox)
    tpos = tnb.wrap_positions(torch.tensor(pos, dtype=torch.float64), tbox)
    jgrid = jcr.RollGrid.for_box(h, SIDE, CAP)
    tgrid = tcr.RollGrid.for_box(h, SIDE, CAP)
    assert tuple(tgrid.ncells) == (6, 6, 6)
    jb = jcr.build_bins(jgrid, jpos, jnp.asarray(species), jbox)
    tb = tcr.build_bins(tgrid, tpos, torch.tensor(species), tbox)
    assert int(tb.count_max) <= CAP
    spec = taev.ani2x_aev_spec()
    ga = np.random.default_rng(7).standard_normal((len(species), 112))
    dpos_j, dh_j = jap._radial_bwd_impl(
        jaev.ani2x_aev_spec(), jgrid, PRESENT, True, SHELL, jpos, jbox.h,
        jb.inv, jb.species_grid, jb.cell, jb.slot, jnp.asarray(ga))
    out = dict(grid=tgrid, bins=tb, spec=spec,
               jax=(np.asarray(dpos_j), np.asarray(dh_j)))
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        pos_g, sp_g = tar._grid_inputs(tb.inv, tpos.to(dtype),
                                       tb.species_grid)
        ga_g = tar._to_grid_rows(tb.inv, torch.tensor(ga, dtype=dtype),
                                 0.0).contiguous()
        args = (pos_g, sp_g, tbox.h.to(dtype).contiguous(), tgrid.ncells,
                SHELL, spec, PRESENT, ga_g)
        out[name] = dict(args=args, emulated=emulate_radial_bwd(*args),
                         plain=tar.radial_bwd_plain(*args))
    return out


@pytest.mark.parametrize("i,label", [(0, "fcen"), (1, "wing"), (2, "dh")])
def test_transcription_matches_plain(case, i, label):
    fcen, wing, dh_part, over = case["f64"]["emulated"]
    got = (fcen, wing, dh_reduce(dh_part))[i]
    ref = case["f64"]["plain"][i]
    scale = (dh_scale(case["grid"].ncells, case["f64"]["plain"][1])
             if label == "dh" else float(ref.abs().max()))
    assert scale > 0 and over == 0
    assert float((got - ref).abs().max()) <= 1e-12 * scale


def test_transcription_matches_jax(case):
    """The folded dpos and dh against the JAX kernel's."""
    fcen, wing, dh_part, _ = case["f64"]["emulated"]
    b = case["bins"]
    dpos = tar._fold_wing(case["grid"].ncells, SHELL, fcen,
                          wing)[b.cell, b.slot]
    dpos_j, dh_j = case["jax"]
    assert np.abs(dpos.numpy() - dpos_j).max() <= 1e-10 * np.abs(
        dpos_j).max()
    dh = dh_reduce(dh_part).numpy()
    assert np.abs(dh - dh_j).max() <= 1e-10 * np.abs(dh_j).max()


@pytest.mark.parametrize("nw,store", [(1, 128), (3, 4), (5, 1)])
def test_wing_order_is_center_order_at_any_warp_count(case, nw, store):
    """The wing, fcen and dh partials are the same bits with any warp count
    and any store size, overflowing or not: every wing entry subtracts the
    centers' g in slot order."""
    args = case["f64"]["args"]
    base = case["f64"]["emulated"]
    got = emulate_radial_bwd(*args, nw=nw, store=store)
    if store < 8:
        assert got[3] > 0  # rounds ran again one center at a time
    for x, y in zip(got[:3], base[:3]):
        assert torch.equal(x.view(torch.int64), y.view(torch.int64))


def test_wing_is_minus_the_center_ordered_sum(case):
    """A wing entry, recomputed lane by lane from the pairs' g in the
    centers' slot order, equals the transcription bit for bit, and the
    plain version's sum to 1e-12."""
    pos_g, sp_g, h, ncells, shell, spec, present, ga_g = case["f64"]["args"]
    wing = case["f64"]["emulated"][1]
    cst = tar.radial_consts(spec)
    win_p, win_s, _ = staged_window(pos_g, sp_g, h, ncells, shell, present)
    cell = int(torch.argmax((sp_g >= 0).sum(1)))
    w = torch.arange(win_s.shape[1])
    checked = 0
    for lane in w[win_s[cell] >= 0][::7].tolist():
        acc = torch.zeros(3, dtype=pos_g.dtype)
        for a in range(sp_g.shape[1]):
            if sp_g[cell, a] < 0 or lane == 62 * CAP + a:
                continue
            dvec = pos_g[cell, a] - win_p[cell, lane]
            d = torch.sqrt(torch.clamp((dvec * dvec).sum(), min=1e-12))
            if d > cst[0]:
                continue
            ga_sp = ga_g[cell, a].reshape(-1, cst[4])[win_s[cell, lane]]
            acc = acc - pair_g(dvec[None], d[None], ga_sp[None], cst,
                               0.0)[0]
            checked += 1
        assert torch.equal(acc.view(torch.int64),
                           wing[cell, lane].view(torch.int64))
    assert checked > 20
    ref = case["f64"]["plain"][1]
    assert float((wing - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_interior_bins_give_exactly_zero_dh(case):
    """With the cotangent on interior bins' rows only (their whole shell-2
    window unshifted), dh is exactly 0 in the transcription and the plain
    version; on the other rows it is not."""
    pos_g, sp_g, h, ncells, shell, spec, present, ga_g = case["f64"]["args"]
    _, shift = window_tab(ncells, CAP, SHELL)
    interior = ~(shift != 0).any(-1).any(-1)
    assert int(interior.sum()) == 8
    for rows, zero in ((interior, True), (~interior, False)):
        ga = torch.where(rows[:, None, None], ga_g, 0.0)
        a = (pos_g, sp_g, h, ncells, shell, spec, present, ga)
        dh_part = emulate_radial_bwd(*a)[2]
        for dh in (dh_reduce(dh_part), tar.radial_bwd_plain(*a)[2]):
            assert bool((dh == 0).all()) == zero
        if zero:
            assert not dh_part.any()


@pytest.mark.parametrize("trig_err", [0.0, HW_TRIG_ERR, -HW_TRIG_ERR])
def test_f32_transcription_within_the_gate(case, trig_err):
    """f32: ex2 Gaussians, the hardware cosine and sine at their worst-case
    error either way, __fdividef: each output against the plain f32
    version within 0.25 of the gate."""
    args = case["f32"]["args"]
    fcen, wing, dh_part, _ = (emulate_radial_bwd(*args, trig_err=trig_err)
                              if trig_err else case["f32"]["emulated"])
    ref = case["f32"]["plain"]
    for got, want, label in ((fcen, ref[0], "fcen"), (wing, ref[1], "wing"),
                             (dh_reduce(dh_part), ref[2], "dh")):
        scale = (dh_scale(case["grid"].ncells, ref[1]) if label == "dh"
                 else float(want.abs().max()))
        err = float((got - want).abs().max())
        assert err <= 0.25 * gate(scale), (label, err, gate(scale))
