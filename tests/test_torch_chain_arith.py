"""The slot chain and its box cotangent as the card computes them
(lammps_ani_torch/csrc/aev_asn.cu: `chain_row`, shared by
`asn_chain_sum_kernel` and `asn_decompact_chain_kernel`; the window table,
`window_tab` / `lane_shift` / `dh_add`, which the radial backward shares;
`dh_reduce_kernel` of csrc/aev_common.cuh), transcribed in numpy and torch:

  * The wrap shift of a compact lane comes from the row's window table
    (27 entries, built once per row), not from the lane's own window
    offset (`offset_of` and `neighbor_bin` per lane); a row of an interior
    bin has S = 0 on every lane and skips the dh terms.
  * Each thread takes four consecutive compact lanes of each 128, so the
    center force and dh are summed in another order than one lane a
    thread would; gt itself is the plain version's expression lane by
    lane.
  * dh_reduce sums the per-block partials in one coalesced pass: thread t
    of 512 adds rows t, t + 512, ... (four rows' loads at a time) into
    nine running sums, the warps add their threads' sums by an xor
    shuffle tree, thread i < 9 the 16 warps' sums in warp order.
  * A row with no live lane (every row with no atom) gets exact zeros.

System: WATER30 x 3^3 (810 atoms, 24 A box), jittered, sorted by species,
3^3 bins at cap 40 (one interior bin), the sizing of
tests/test_torch_asn_build.py; the forward's slots and rank2 from the
plain step, the radial part gr from the plain radial backward, seeded
slot cotangents.
"""

import math

import numpy as np
import pytest
import torch

from lammps_ani_torch.models import aev as taev
from lammps_ani_torch.ops import aev_asn as tasn
from lammps_ani_torch.ops import aev_roll as tar

from .test_torch_asn_build import KEEP_R, asn_system, grids, sizing

RED_THREADS, RED_ROWS = 512, 4  # dh_reduce_kernel's
WARPS_PER_BLOCK = 8             # rows (warps) of a chain block

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: with several test processes on one machine, each
    with a thread per core, the threads wait on one another at every
    operation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def gate(scale):
    return 5e-6 + 1e-5 * scale


# ---------------------------------------------------------------------------
# The window table
# ---------------------------------------------------------------------------


def neighbor_shift(ncells, cell, o):
    """`offset_of` (shell 1) and `neighbor_bin`'s wrap shift of window
    offset o of bins `cell` (arrays): [.., 3]."""
    nx, ny, nz = ncells
    iz, iy, ix = cell % nz, (cell // nz) % ny, cell // (ny * nz)
    off = (o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1)
    s = [np.where(i + d < 0, -1, np.where(i + d >= n, 1, 0))
         for i, d, n in zip((ix, iy, iz), off, (nx, ny, nz))]
    return np.stack(s, axis=-1)


def window_table(ncells):
    """`window_tab`'s shift codes [NC, 27]: (sx+1) | (sy+1) << 2 |
    (sz+1) << 4 of each window offset."""
    nc = int(np.prod(ncells))
    cell = np.arange(nc)[:, None]
    s = neighbor_shift(ncells, cell, np.arange(27)[None, :])
    return (s[..., 0] + 1) | (s[..., 1] + 1) << 2 | (s[..., 2] + 1) << 4


def table_shift(tab, w, cap):
    """`lane_shift` then `dh_add`'s unpacking: S [.., 3] of window lanes w
    of the rows of `tab` (a dead lane, w >= 27 cap: offset 13, S = 0)."""
    o = np.where(w < 27 * cap, w // cap, 13)
    code = np.take_along_axis(tab, o, axis=1)
    return np.stack([(code & 3) - 1, (code >> 2 & 3) - 1,
                     (code >> 4 & 3) - 1], axis=-1)


def bin_interior(ncells):
    nx, ny, nz = ncells
    cell = np.arange(nx * ny * nz)
    iz, iy, ix = cell % nz, (cell // nz) % ny, cell // (ny * nz)
    return ((ix > 0) & (ix < nx - 1) & (iy > 0) & (iy < ny - 1)
            & (iz > 0) & (iz < nz - 1))


@pytest.mark.parametrize("ncells", [(3, 3, 3), (4, 5, 6), (16, 16, 16)])
def test_window_table_shift_equals_the_per_lane_shift(ncells):
    """For every bin and every window lane (cap 3) and a dead lane: the
    table's shift equals the per-lane shift (the lane's own offset
    through `offset_of` and `neighbor_bin`, a dead lane none) and the
    plain version's table (`aev_asn._shift_tables`, entry 27 for a dead
    lane); an interior bin's 27 shifts are all 0, every other bin has a
    nonzero one."""
    cap = 3
    nc = int(np.prod(ncells))
    wpad = tasn._round_lane(27 * cap)
    w = np.concatenate([np.arange(27 * cap), [wpad]])[None, :].repeat(nc, 0)
    got = table_shift(window_table(ncells), w, cap)
    o = w // cap
    per_lane = neighbor_shift(ncells, np.arange(nc)[:, None],
                              np.minimum(o, 26))
    per_lane = np.where((o < 27)[..., None], per_lane, 0)
    assert np.array_equal(got, per_lane)
    plain = tasn._shift_tables(ncells, torch.float64, "cpu").numpy()
    assert np.array_equal(got, plain[np.arange(nc)[:, None],
                                     np.minimum(o, 27)])
    inner = bin_interior(ncells)
    assert inner.sum() == np.prod([m - 2 for m in ncells])
    assert not got[inner].any()
    assert got[~inner].reshape(int((~inner).sum()), -1).any(1).all()


# ---------------------------------------------------------------------------
# dh_reduce
# ---------------------------------------------------------------------------


def warp_xor_sum(x):
    """The xor shuffle tree over the last axis (32 lanes): every lane ends
    with the same sum; returns lane 0's."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ o]
    return x[..., 0]


def dh_reduce(part):
    """dh_reduce_kernel on part [n, 9]: [9]."""
    n = part.shape[0]
    acc = np.zeros((RED_THREADS, 9))
    t = np.arange(RED_THREADS)
    for r0 in range(0, n, RED_ROWS * RED_THREADS):
        v = []
        for b in range(RED_ROWS):
            r = r0 + b * RED_THREADS + t
            v.append(np.where((r < n)[:, None],
                              part[np.minimum(r, n - 1)], 0.0))
        for b in range(RED_ROWS):
            acc = acc + v[b]
    warp = warp_xor_sum(acc.T.reshape(9, RED_THREADS // 32, 32))  # [9, 16]
    out = np.zeros(9)
    for wi in range(RED_THREADS // 32):
        out = out + warp[:, wi]
    return out


@pytest.mark.parametrize("n", [1, 513, 9261, 18432, 20000])
def test_dh_reduce_order_is_fixed_and_agrees_with_torch_sum(n):
    """f64: two runs give the same bits; the sum agrees with torch.sum and
    with the exactly rounded sum (math.fsum) within 1e-15 of the sum of
    the terms' magnitudes (n: one row, a few rows a thread, the roll
    grid's 21^3 bins, the 101,250-atom box's 18,432 blocks of 8 rows, and
    a count off the batch)."""
    rng = np.random.default_rng(n)
    part = rng.standard_normal((n, 9)) * np.exp(rng.uniform(-3, 3, (n, 9)))
    got = dh_reduce(part)
    assert np.array_equal(got.view(np.int64), dh_reduce(part).view(np.int64))
    scale = np.abs(part).sum(0)
    want = torch.tensor(part).sum(0).numpy()
    exact = np.array([math.fsum(part[:, i]) for i in range(9)])
    assert (np.abs(got - want) <= 1e-15 * scale).all()
    assert (np.abs(got - exact) <= 1e-15 * scale).all()


# ---------------------------------------------------------------------------
# The chain on the 810-atom system
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chain():
    """Per dtype: the chain's inputs at the 810-atom rebuild and the plain
    version's (gt, fcen, dh)."""
    species, pos, h, origin = asn_system()
    sections, kpad, caps, _ = sizing(species, pos, h)
    spec = taev.ani2x_aev_spec()
    rng = np.random.default_rng(21)
    out = {"spec": spec}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        _, t = grids(species, pos, h, origin, dtype)
        a = tasn.build_assignment(t["grid"], t["bins"], t["pos"], t["box"],
                                  sections, kpad, KEEP_R)
        assert float(a.ovf) <= 0
        pos_g, sp_g = tar._grid_inputs(t["bins"].inv, t["pos"],
                                       t["bins"].species_grid)
        ncells, hh = t["grid"].ncells, t["box"].h
        _, cmp, rank2, _ = tasn.step_fused_plain(
            pos_g, sp_g, hh, a.idx, ncells, spec, sections, caps, None)
        nc, cap = sp_g.shape
        atot = cmp.shape[-1]
        gsum = torch.tensor(rng.standard_normal((nc, cap, 5, atot)),
                            dtype=dtype)
        ga = torch.tensor(rng.standard_normal(
            (nc, cap, len(sections) * 16 + 1)), dtype=dtype)
        gr = tasn.radial_gamma_plain(pos_g, sp_g, hh, a.idx, ga, ncells,
                                     spec, sections, None)
        args = (rank2, a.idx, cmp, gsum, gr, ncells, spec)
        out[name] = dict(args=args, sp_g=sp_g,
                         plain=tasn.chain_sum_plain(*args),
                         plain_decompact=tasn.decompact_chain_plain(
                             rank2, a.idx, cmp, gsum, ncells, spec))
    return out


def kernel_chain(args, f32, add_radial=True):
    """(gt, fcen, dh) as the chain kernel computes them, in numpy: rows
    with no live lane are zero; slot vectors (f32: 1 / d exactly
    rounded, for __fdividef(1, d)); four lanes a thread per 128; fcen and
    dh by thread, then the xor tree; dh partials per block of 8 rows in
    warp order, then `dh_reduce`."""
    rank2, idx, cmp, gsum, gr, ncells, spec = args
    dt = np.float32 if f32 else np.float64
    nc, cap, kpad = idx.shape
    rows = nc * cap
    atot = cmp.shape[-1]
    idx = idx.numpy().reshape(rows, kpad).astype(np.int64)
    r2 = rank2.numpy().reshape(rows, kpad).astype(np.int64)
    c = cmp.numpy().reshape(rows, 6, atot)
    gs = gsum.numpy().reshape(rows, 5, atot)
    g0 = (gr.numpy().reshape(rows, 3, kpad) if add_radial
          else np.zeros((rows, 3, kpad), dt))
    live_row = (idx < 27 * cap).any(1)
    d = c[:, 3]
    slot_live = d < dt(spec.angular_cutoff + 5.0)
    with np.errstate(divide="ignore"):
        inv_d = np.where(slot_live, (1.0 / d.astype(np.float64)).astype(dt),
                         dt(0))
    gu = gs[:, 0:3]
    u = c[:, 0:3]
    dot = gu[:, 0] * u[:, 0] + gu[:, 1] * u[:, 1] + gu[:, 2] * u[:, 2]
    g_cd = np.where(slot_live, gs[:, 3] + gs[:, 4] * c[:, 5] - dot * inv_d,
                    dt(0))
    v = gu * inv_d[:, None] + g_cd[:, None] * u            # [rows, 3, atot]
    v = np.concatenate([v, np.zeros((rows, 3, 1), dt)], 2)
    slot = np.where((r2 >= 0) & (r2 < atot), r2, atot)
    gt = g0 + np.take_along_axis(v, slot[:, None, :].repeat(3, 1), 2)
    gt = np.where(live_row[:, None, None], gt, dt(0))

    # fcen: thread t adds lanes 4t..4t+3 of each 128, then the xor tree
    lanes = gt.reshape(rows, 3, -1, 32, 4)                 # [.., chunk, t, j]
    fsum = np.zeros((rows, 3, 32), dt)
    for ch in range(lanes.shape[2]):
        for j in range(4):
            fsum = fsum + lanes[:, :, ch, :, j]
    fcen = np.where(live_row[:, None], warp_xor_sum(fsum), dt(0))

    # dh: per thread, then per warp, then per block of 8 rows
    tab = np.repeat(window_table(ncells), cap, axis=0)    # [rows, 27]
    s = table_shift(tab, idx, cap).astype(dt)             # [rows, kpad, 3]
    face = np.repeat(~bin_interior(ncells), cap) & live_row
    s4 = s.reshape(rows, -1, 32, 4, 3)
    dh = np.zeros((rows, 9, 32), dt)
    for ch in range(s4.shape[1]):
        for j in range(4):
            g = lanes[:, :, ch, :, j]                      # [rows, 3, 32]
            sv = s4[:, ch, :, j]                           # [rows, 32, 3]
            for m in range(3):
                for cc in range(3):
                    dh[:, m * 3 + cc] = (dh[:, m * 3 + cc]
                                         - sv[:, :, m] * g[:, cc])
    warp_dh = np.where(face[:, None], warp_xor_sum(dh), dt(0))
    blocks = -(-rows // WARPS_PER_BLOCK)
    warp_dh = np.concatenate(
        [warp_dh, np.zeros((blocks * WARPS_PER_BLOCK - rows, 9), dt)])
    part = np.zeros((blocks, 9), dt)
    for wi in range(WARPS_PER_BLOCK):
        part = part + warp_dh[wi::WARPS_PER_BLOCK]
    dh_tot = dh_reduce(part.astype(np.float64)) if not f32 else \
        dh_reduce_f32(part)
    return gt.reshape(nc, cap, 3, kpad), fcen.reshape(nc, cap, 3), \
        dh_tot.reshape(3, 3)


def dh_reduce_f32(part):
    """`dh_reduce` with every add rounded to f32."""
    n = part.shape[0]
    acc = np.zeros((RED_THREADS, 9), np.float32)
    t = np.arange(RED_THREADS)
    for r0 in range(0, n, RED_ROWS * RED_THREADS):
        for b in range(RED_ROWS):
            r = r0 + b * RED_THREADS + t
            acc = acc + np.where((r < n)[:, None],
                                 part[np.minimum(r, n - 1)], np.float32(0))
    warp = warp_xor_sum(acc.T.reshape(9, RED_THREADS // 32, 32))
    out = np.zeros(9, np.float32)
    for wi in range(RED_THREADS // 32):
        out = out + warp[:, wi]
    return out


def dh_scale(args, gt):
    """Sum over lanes of |S| |gt| (chip_smoke's scale of dh)."""
    _, idx, _, _, _, ncells, _ = args
    nc, cap, kpad = idx.shape
    tab = np.repeat(window_table(ncells), cap, axis=0)
    s = np.abs(table_shift(tab, idx.numpy().reshape(-1, kpad).astype(
        np.int64), cap)).astype(np.float64)
    g = np.abs(np.asarray(gt, np.float64)).reshape(-1, 3, kpad)
    return float(np.einsum("rkm,rck->mc", s, g).max())


@pytest.mark.parametrize("add_radial", [True, False],
                         ids=["chain_sum", "decompact_chain"])
def test_f64_chain_transcription_against_the_plain_version(chain,
                                                          add_radial):
    """f64: gt equal to the plain version's bits on every lane; fcen and
    dh, summed in the kernel's order, within 1e-14 of their terms'
    magnitude sums."""
    args = chain["f64"]["args"]
    gt, fcen, dh = kernel_chain(args, False, add_radial)
    want = chain["f64"]["plain" if add_radial else "plain_decompact"]
    assert np.array_equal(gt, want[0].numpy())
    f_scale = float(np.abs(gt).sum(-1).max())
    assert np.abs(fcen - want[1].numpy()).max() <= 1e-14 * f_scale
    scale = dh_scale(args, gt)
    assert scale > 1.0 and np.abs(want[2].numpy()).max() > 0
    assert np.abs(dh - want[2].numpy()).max() <= 1e-14 * scale


def test_f32_chain_transcription_within_the_gate(chain):
    """f32: gt, fcen and dh against the plain version in f32 within 0.1 of
    the gate at each output's scale (dh: its terms' magnitude sum)."""
    args = chain["f32"]["args"]
    gt, fcen, dh = kernel_chain(args, True)
    want = [w.numpy() for w in chain["f32"]["plain"]]
    for got, ref, scale in ((gt, want[0], float(np.abs(want[0]).max())),
                            (fcen, want[1], float(np.abs(want[1]).max())),
                            (dh, want[2], dh_scale(args, want[0]))):
        err = float(np.abs(got - ref).max())
        assert err <= 0.1 * gate(scale), (err, gate(scale))


def test_rows_without_a_live_lane_give_exact_zeros(chain):
    """The plain versions (which the kernel's shortcut relies on) give gt
    and fcen exactly 0 on every row with no live lane, a superset of the
    rows with no atom, and on every dead lane."""
    for name in ("f64", "f32"):
        c = chain[name]
        idx = c["args"][1]
        cap = idx.shape[1]
        dead = idx.to(torch.int64) >= 27 * cap
        no_live = dead.all(-1)
        empty = c["sp_g"] < 0
        assert empty.any() and bool(no_live[empty].all())
        for gt, fcen, _ in (c["plain"], c["plain_decompact"]):
            assert not gt[no_live].any() and not fcen[no_live].any()
            assert not gt[dead[:, :, None, :].expand_as(gt)].any()
            assert gt.abs().max() > 0


def test_interior_rows_add_nothing_to_dh(chain):
    """With the slot cotangents and the radial part kept on the interior
    bin's rows only, the plain chain's dh is exactly 0 while those rows'
    gt is not."""
    rank2, idx, cmp, gsum, gr, ncells, spec = chain["f64"]["args"]
    inner = torch.tensor(bin_interior(ncells))
    assert inner.sum() == 1

    def keep(t):
        return torch.where(inner.reshape((-1,) + (1,) * (t.dim() - 1)), t,
                           0.0)

    gt, _, dh = tasn.chain_sum_plain(rank2, idx, cmp, keep(gsum), keep(gr),
                                     ncells, spec)
    assert gt[inner].abs().max() > 0
    assert not dh.any()
