"""The grid caps the roll kernels take (lammps_ani_torch/csrc/aev_roll.cu).

radial_bwd takes every cap up to 256 in both dtypes: its block stages the
shell-s window in passes of whole offsets, an x-plane ((2s + 1)^2
offsets) where a block of 8 warps holds the pass's layout, else an x-y row
(2s + 1 offsets), else one offset (`kernel_offsets` transcribes the host's
rule). The kernel's walk with its passes is transcribed here (the plane
walk of tests/test_torch_roll_radial_bwd_order.py with passes of `opp`
offsets) and held against the plain version on a grid padded with empty
slots to cap 128 in f64, which takes 25 passes of a row.

angular_fwd and angular_bwd take every cap up to 256 too: where their
whole-window layout fits a block (every cap the engines size) they keep a
bin's 27-bin window in one block, above it they stage it in passes of
whole offsets with each center's compaction carried from pass to pass
(`aev_roll.angular_form` gives the offsets a pass: the host's rule,
transcribed). `aev_roll.angular_cap_limit` is 256 in both dtypes at the
engines' caps (on the card the kernels' own export, here its
transcription), against the layouts' bytes worked out here; the pass
walk, transcribed, keeps every center's slots of the whole window at a
padded cap; the wrappers raise a ValueError naming the kernel, the cap,
the dtype and the limit at cap 260 before any launch, and `Simulation`
raises it at init_state and at a regrow. chip_smoke.py launches each
kernel at cap 256 in f64 and f32 on the card against the plain version,
its pass form at the grid's own cap against the whole window bit for bit,
and checks that cap 257 raises.

System: WATER30 x 3^3 (810 atoms, 24 A box) on the roll engine's fine grid
(6 x 6 x 6 bins at cap 12), a seeded cotangent. Limits: f64 against the
plain version 1e-12 of each output's largest magnitude (dh: of the sum of
its terms' magnitudes); rows and lanes of the padding exactly 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

import lammps_ani_torch as tlat
from lammps_ani_torch.models import aev as taev
from lammps_ani_torch.models import zoo as tzoo
from lammps_ani_torch.ops import aev_roll as tar
from lammps_ani_torch.ops import cell_roll as tcr
from lammps_ani_torch.md import simulation as tsm
from lammps_ani_torch.ops import neighbors as tnb

from .test_torch_build_inv_order import stage_window
from .test_torch_neighbors import water_system
from .test_torch_roll_angular_bwd_order import compact
from .test_torch_roll_radial_bwd_order import (CAP, PRESENT, SHELL, SIDE,
                                               dh_reduce, lane_sums, pair_g,
                                               staged_window, warp_sum)

PAD_CAP = 128
BUDGET = 227 * 1024 - 2048  # a block's dynamic shared memory


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def al16(b):
    return (b + 15) // 16 * 16


def rb_bytes(cap, shell, sr, opp, dtype, warps=8):
    """radial_bwd's dynamic shared memory (`rb_layout`): a pass's kept
    lanes (16 B in f32, 32 in f64) and wing [3 opp cap], fcen [3 cap],
    per-offset sums [3 n_off], centers int [cap]; a warp's cotangent row
    [S NR], 64 packed entries (int) and values [4][64], and a store of
    128 lanes."""
    t = 4 if dtype == torch.float32 else 8
    lane = 4 * t
    n_off = (2 * shell + 1) ** 3
    fixed = (al16(lane * opp * cap) + al16(t * 3 * opp * cap)
             + al16(t * 3 * cap) + al16(t * 3 * n_off) + al16(4 * cap))
    warp = al16(t * sr) + al16(4 * 64) + al16(t * 4 * 64) + lane * 128
    return fixed + warps * warp


def kernel_offsets(cap, shell, sr, dtype):
    """The offsets radial_bwd stages a pass (its host's rule): a plane, a
    row or one offset, the first whose layout fits 8 warps."""
    ns = 2 * shell + 1
    opp = ns * ns
    while opp > 1 and rb_bytes(cap, shell, sr, opp, dtype) > BUDGET:
        opp //= ns
    return opp


def emulate_passes(pos_g, sp_g, h, ncells, shell, spec, present, ga_g, opp,
                   cells=None):
    """(fcen, wing, dh partials) of radial_bwd staging `opp` offsets a
    pass: per pass the kept lanes in lane order; each real center's pairs
    within Rcr go to its lanes in order (fcen: lane sums then a warp sum,
    added pass after pass), the wing subtracts the centers' g in slot
    order (the kernel's rounds of warps give the same values in the same
    order), dh from per-offset wing sums. `cells`: the bins computed (the
    others stay 0)."""
    cst = tar.radial_consts(spec)
    rc, nr = cst[0], cst[4]
    dtype = pos_g.dtype
    nc, cap = sp_g.shape
    n_off = (2 * shell + 1) ** 3
    self_off = (n_off - 1) // 2
    win_p, win_s, shift = staged_window(pos_g, sp_g, h, ncells, shell,
                                        present)
    fcen = torch.zeros((nc, cap, 3), dtype=dtype)
    wing = torch.zeros((nc, n_off * cap, 3), dtype=dtype)
    dh_part = torch.zeros((nc, 9), dtype=dtype)
    rc2_hi = float(torch.tensor(rc, dtype=dtype)) ** 2 * (1 + 2.0 ** -20)
    for cell in (range(nc) if cells is None else cells):
        ctr = [a for a in range(cap) if sp_g[cell, a] >= 0]
        osum = torch.zeros((n_off, 3), dtype=dtype)
        for o0 in range(0, n_off, opp):
            no = min(opp, n_off - o0)
            w0, pl = o0 * cap, no * cap
            lanes = torch.arange(w0, w0 + pl)
            kept = lanes[win_s[cell, w0:w0 + pl] >= 0]
            wing_p = torch.zeros((pl, 3), dtype=dtype)
            for a in ctr:
                dvec = pos_g[cell, a] - win_p[cell, kept]
                d2 = (dvec * dvec).sum(-1)
                d = torch.sqrt(torch.clamp(d2, min=1e-12))
                m = (kept != self_off * cap + a) & (d2 <= rc2_hi) & (d <= rc)
                ga_sp = ga_g[cell, a].reshape(-1, nr)[win_s[cell, kept[m]]]
                g = pair_g(dvec[m], d[m], ga_sp, cst, 0.0)
                fcen[cell, a] += lane_sums(g)
                lw = kept[m] - w0
                wing_p[lw] = wing_p[lw] - g
            wing[cell, w0:w0 + pl] = wing_p
            # an offset's sum: lane l adds slots l, l + 32, ...; a warp sum
            per = wing_p.reshape(no, cap, 3).transpose(0, 1)
            lanes32 = torch.zeros((32, no, 3), dtype=dtype)
            for b0 in range(0, cap, 32):
                blk = per[b0:b0 + 32]
                lanes32[:blk.shape[0]] = lanes32[:blk.shape[0]] + blk
            osum[o0:o0 + no] = warp_sum(lanes32)
        if bool((shift[cell] != 0).any()):
            for i in range(9):
                m_, c_ = divmod(i, 3)
                acc = torch.zeros((), dtype=dtype)
                for o in range(n_off):
                    sm = int(shift[cell, o, m_])
                    if sm:
                        acc = acc + sm * osum[o, c_]
                dh_part[cell, i] = acc
    return fcen, wing, dh_part


def padded(args, cap):
    """The grid inputs with every bin padded with empty slots (parked at
    1e6, species -1, a seeded cotangent) to `cap` slots."""
    pos_g, sp_g, h, ncells, shell, spec, present, ga_g = args
    nc, c0 = sp_g.shape
    p = pos_g.new_full((nc, cap, 3), 1e6)
    p[:, :c0] = pos_g
    s = sp_g.new_full((nc, cap), -1)
    s[:, :c0] = sp_g
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (nc, cap, ga_g.shape[-1])))
    g[:, :c0] = ga_g
    return p, s, h, ncells, shell, spec, present, g


@pytest.fixture(scope="module")
def case():
    species, pos, h, origin, _ = water_system(3)
    tbox = tnb.Box(h=torch.tensor(h), origin=torch.tensor(origin))
    tpos = tnb.wrap_positions(torch.tensor(pos, dtype=torch.float64), tbox)
    grid = tcr.RollGrid.for_box(h, SIDE, CAP)
    assert tuple(grid.ncells) == (6, 6, 6)
    tb = tcr.build_bins(grid, tpos, torch.tensor(species), tbox)
    spec = taev.ani2x_aev_spec()
    ga = np.random.default_rng(7).standard_normal((len(species), 112))
    pos_g, sp_g = tar._grid_inputs(tb.inv, tpos, tb.species_grid)
    ga_g = tar._to_grid_rows(tb.inv, torch.tensor(ga), 0.0).contiguous()
    args = (pos_g, sp_g, tbox.h.contiguous(), grid.ncells, SHELL, spec,
            PRESENT, ga_g)
    big = padded(args, PAD_CAP)
    opp = kernel_offsets(PAD_CAP, SHELL, 112, torch.float64)
    cells = range(0, 216, 3)
    return dict(args=args, plain=tar.radial_bwd_plain(*args), opp=opp,
                cells=cells, padded=emulate_passes(*big, opp, cells),
                plane=emulate_passes(*args, 25, cells))


def test_pass_sizes_of_the_host():
    """The host stages an x-plane at the caps the engines size and at cap
    256 in f32; at cap 256 in f64 a row (25 passes); a pass of one offset
    fits at every cap up to 256 in both dtypes."""
    for dtype in (torch.float32, torch.float64):
        for cap in (12, 32, 48):
            for shell in (1, 2):
                assert kernel_offsets(cap, shell, 112, dtype) == (
                    2 * shell + 1) ** 2
        assert rb_bytes(256, 2, 112, 1, dtype) <= BUDGET
    assert kernel_offsets(256, 2, 112, torch.float32) == 25
    assert kernel_offsets(256, 2, 112, torch.float64) == 5
    assert kernel_offsets(256, 1, 112, torch.float64) == 9
    assert kernel_offsets(PAD_CAP, 2, 112, torch.float64) == 5
    # the layout's bytes at cap 256, f64, a plane and a row, by hand: kept
    # lanes opp*256*32, wing opp*256*24, fcen 256*24, offset sums 125*24
    # (to 16), centers 256*4; 8 warps of 112*8 + 256 + 2048 + 128*32 bytes
    rest = 6144 + 3008 + 1024 + 8 * (896 + 256 + 2048 + 4096)
    assert rb_bytes(256, 2, 112, 25, torch.float64) == 358400 + rest
    assert rb_bytes(256, 2, 112, 5, torch.float64) == 71680 + rest
    assert 358400 + rest > BUDGET >= 71680 + rest


def test_passes_match_plain_on_the_padded_grid(case):
    """Cap 128 in f64 (25 passes of a row, 16,000 window lanes a bin; every
    third bin): the real rows' fcen and the real lanes' wing against the
    plain version on the unpadded grid, the dh partials the plane walk's
    bit for bit on the unpadded grid (each offset's sum lies in one pass);
    the padding's rows and lanes are exactly 0."""
    assert case["opp"] == 5
    fcen, wing, dh_part = case["padded"]
    cells = list(case["cells"])
    ref = case["plain"]
    nc = fcen.shape[0]
    w = wing.reshape(nc, 125, PAD_CAP, 3)
    assert not fcen[:, CAP:].any() and not w[:, :, CAP:].any()
    got = (fcen[:, :CAP], w[:, :, :CAP].reshape(nc, 125 * CAP, 3))
    for x, y in zip(got, ref):
        scale = float(y.abs().max())
        assert scale > 0 and bool(x[cells].any())
        assert float((x[cells] - y[cells]).abs().max()) <= 1e-12 * scale
    plane = case["plane"][2]
    assert bool(plane.any())
    assert torch.equal(dh_part.view(torch.int64), plane.view(torch.int64))


def test_passes_keep_the_wing_and_dh_bits(case):
    """On the unpadded grid (every sixth bin), passes of a row against
    the plane's 25: the wing and the dh partials are the same bits (each
    entry lies in one pass, a sum in center order), fcen within 1e-13 (its
    lane sums break at each pass)."""
    args = case["args"]
    cells = range(0, 216, 6)
    plane = emulate_passes(*args, 25, cells)
    cut = emulate_passes(*args, 5, cells)
    assert bool(plane[2].any())
    for i in (1, 2):
        assert torch.equal(cut[i].view(torch.int64),
                           plane[i].view(torch.int64))
    scale = float(plane[0].abs().max())
    assert float((cut[0] - plane[0]).abs().max()) <= 1e-13 * scale


CAPS = (24, 0, 0, 16, 0, 0, 0)  # the roll state's caps, H and O present


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_angular_limits_are_the_layouts(dtype):
    """At the roll state's caps both angular kernels take every grid cap
    up to 256 and none above: the whole-window layout (one warp) at the
    caps the engines size, the pass form's above it. By hand, A = 40,
    Q = 384: angular_fwd's whole window at cap 256 (27 x 256 staged lanes
    and a warp's slots [5][A]) fits in both dtypes; angular_bwd's (the
    window, the centers' results [cap][A] and a warp's scratch) does not,
    and its pass form stages an x-plane (9 offsets, the real centers int
    [cap], 8 warps of scratch and results [A]) at cap 256."""
    t = 4 if dtype == torch.float32 else 8
    lane = 4 * t
    warp = al16(t * (11 * 40 + 3 * 384 + 32) + 4 * 40)
    whole_bwd = max(c for c in range(257)
                    if 27 * lane * c + lane * 40 * c + al16(4 * c) + warp
                    <= BUDGET)
    assert whole_bwd == (207 if t == 4 else 101)
    assert 27 * lane * 256 + t * 5 * 40 <= BUDGET
    plane = al16(9 * 256 * lane) + al16(4 * 256) + 8 * (warp + lane * 40)
    assert plane <= BUDGET
    for name in ("angular_fwd", "angular_bwd"):
        assert tar.angular_cap_limit(name, dtype, CAPS) == 256
        for cap in (12, 32, 48):
            assert tar.angular_form(name, cap, CAPS, dtype) == 27
        assert tar.angular_form(name, 257, CAPS, dtype) == 0
    assert tar.angular_form("angular_fwd", 256, CAPS, dtype) == 27
    assert tar.angular_form("angular_bwd", whole_bwd, CAPS, dtype) == 27
    assert tar.angular_form("angular_bwd", whole_bwd + 1, CAPS, dtype) == 9
    assert tar.angular_form("angular_bwd", 256, CAPS, dtype) == 9
    assert tar.angular_pass_smem("angular_bwd", 256, CAPS, dtype, 9,
                                 8) == plane
    # the largest A whose backward scratch (its pair scalars grow as A^2)
    # still takes cap 256, one species alone: 188 in f32, 131 in f64
    a_max = 188 if t == 4 else 131
    for a, lim in ((a_max, 256), (a_max + 1, None)):
        got = tar.angular_cap_limit("angular_bwd", dtype,
                                    (a, 0, 0, 0, 0, 0, 0))
        assert got == lim if lim else got < 256
    # per-species caps whose backward scratch fits no block even in
    # passes (one warp, one offset): no grid cap at all
    assert tar.angular_cap_limit("angular_bwd", dtype,
                                 (200, 0, 0, 200, 0, 0, 0)) == 0


@pytest.mark.parametrize("name", ["angular_fwd", "angular_bwd"])
def test_wrapper_raises_before_any_launch(case, monkeypatch, name):
    """The wrapper on the card's route: at cap 256 it launches; at cap
    260, a ValueError naming the kernel, the cap, the dtype and the limit,
    and no launch."""
    launched = []
    monkeypatch.setattr(tar, "_route", lambda *a: True)
    monkeypatch.setattr(tar, "_launch",
                        lambda n, *a: launched.append(n))
    pos_g, sp_g, h, ncells, _, spec, _, _ = case["args"]
    assert tar.angular_cap_limit(name, torch.float64, CAPS) == 256
    for cap in (256, 260):
        p, s, _, _, _, _, _, g = padded(
            (pos_g, sp_g, h, ncells, 1, spec, (0, 3),
             pos_g.new_zeros(pos_g.shape[:2] + (896,))), cap)

        def call(p=p, s=s, g=g):
            if name == "angular_fwd":
                return tar.angular_fwd(p, s, h, ncells, spec, CAPS, (0, 3))
            return tar.angular_bwd(p, s, h, ncells, spec, CAPS, (0, 3), g)

        if cap == 256:
            call()
            assert launched == [name]
        else:
            with pytest.raises(ValueError) as err:
                call()
            msg = str(err.value)
            assert (name in msg and "cap 260" in msg and "float64" in msg
                    and "256" in msg)
            assert launched == [name]


def pass_walk(cst, caps, present, pos_g, win_p, win_s, opp, cells):
    """Slot lanes [NC, cap, atot] (window lane, or -1) of the pass forms'
    compaction: per pass of `opp` window offsets, the pass's lanes of
    present species compacted in lane order, 32 at a time, each species'
    in-Rca lanes ranked with a carry that goes on from pass to pass (self
    excluded by its window lane); only the bins `cells`."""
    nc, cap = pos_g.shape[:2]
    slot0 = np.concatenate([[0], np.cumsum(caps)[:-1]])
    out = torch.full((nc, cap, sum(caps)), -1, dtype=torch.int64)
    self_lane = 13 * cap + torch.arange(cap)
    for b in cells:
        carry = {s: torch.zeros(cap, dtype=torch.int64) for s in present}
        for o0 in range(0, 27, opp):
            lanes = torch.arange(o0 * cap, (o0 + opp) * cap)
            kept = lanes[win_s[b, lanes] >= 0]
            for base in range(0, len(kept), 32):
                ln = kept[base:base + 32]
                d = pos_g[b, :, None, :] - win_p[b, None, ln, :]
                dist = torch.sqrt(torch.clamp((d * d).sum(-1), min=1e-12))
                sw = win_s[b, ln][None, :]
                ok = (dist <= cst["rca"]) & (ln[None, :]
                                              != self_lane[:, None])
                for s in present:
                    bal = (ok & (sw == s)).to(torch.int64)
                    rank = carry[s][:, None] + torch.cumsum(bal, -1) - bal
                    keep = (bal > 0) & (rank < caps[s])
                    a, k = torch.nonzero(keep, as_tuple=True)
                    out[b, a, int(slot0[s]) + rank[keep]] = ln[k]
                    carry[s] += bal.sum(-1)
    return out


def test_pass_walk_compacts_the_whole_windows_slots(case):
    """On the grid padded to cap 128 (f64, every fourth bin), the pass
    forms' walk in planes (the offsets the backward's host picks there),
    rows and single offsets gives every center the slots the whole window
    gives (tests/test_torch_roll_angular_bwd_order.py's `compact`, the
    whole-window kernels' walk): the first caps[s] in-Rca lanes of species
    s in ascending window lane order; and the real centers fill slots."""
    pos_g, sp_g, h, ncells, _, spec, _, ga = case["args"]
    caps = (20, 0, 0, 12, 0, 0, 0)
    p, s, *_ = padded((pos_g, sp_g, h, ncells, 1, spec, (0, 3),
                       ga), PAD_CAP)
    cst = tar.angular_consts(spec, torch.float64)
    win_p, win_s = stage_window(p, s, h, ncells, (0, 3))
    whole, _, _ = compact(cst, caps, (0, 3), p, win_p, win_s)
    opp = tar.angular_form("angular_bwd", PAD_CAP, caps, torch.float64)
    assert opp == 9
    cells = range(0, p.shape[0], 4)
    for o in (opp, 3, 1):
        walk = pass_walk(cst, caps, (0, 3), p, win_p, win_s, o, cells)
        assert torch.equal(walk[list(cells)], whole[list(cells)])
    assert bool((whole[list(cells)][:, :CAP] >= 0).any())
    assert not bool((whole[:, CAP:] >= 0).any())


def _roll_sim(caps=None):
    species, pos, h, origin, masses = water_system(3)
    pot = tzoo.ani2x(num_models=1, dtype=torch.float64, device="cpu")
    if caps is not None:
        pot = pot.with_spec(dataclasses.replace(pot.spec, angular_caps=caps))
    sim = tlat.Simulation(
        potential=pot, species=species, masses=masses,
        nbr=tlat.NeighborConfig(cutoff=5.1, rebuild_every=2,
                                ghost_capacity=4096, k_max=192),
        dt=0.2, dtype=torch.float64, device="cpu", engine="pallas_full",
        auto_angular_caps=caps is None)
    box = tlat.Box(h=torch.tensor(h), origin=torch.tensor(origin))
    return sim, pos, box


def test_simulation_raises_at_init_state(monkeypatch):
    """pallas_full at a grid cap of 260 (the occupancy's margin raised):
    init_state raises the named error before any force evaluation; so it
    does with angular caps whose backward block cannot hold even one slot
    (caps 200, 200: a warp's pair scalars alone take 960 KB) at any cap."""
    calls = []
    for margin, caps, match in (
            (None, None, r"angular_fwd: grid cap 260 above 256, .*float64"),
            (4, (200, 0, 0, 200, 0, 0, 0),
             r"angular_bwd: grid cap \d+ above 0, .*float64")):
        sim, pos, box = _roll_sim(caps)
        monkeypatch.setattr(sim, "_forces", lambda *a: calls.append(a))
        if margin is None:
            probe = tcr.RollGrid.for_box(box.h.numpy(), sim._roll_side, 4)
            cnt = int(tcr.build_bins(probe, tnb.wrap_positions(
                torch.tensor(pos)[sim.order], box), sim.species,
                box).count_max)
            margin = 260 - 2 - cnt
        monkeypatch.setattr(tsm, "ROLL_CAP_MARGIN", margin)
        with pytest.raises(ValueError, match=match):
            sim.init_state(pos, box)
    assert not calls


def test_simulation_raises_at_a_regrow(monkeypatch):
    """A regrow of the roll grid's cap past 256 raises the named error at
    the regrow, not in a kernel launch; one to 256 does not."""
    sim, pos, box = _roll_sim((20, 0, 0, 12, 0, 0, 0))
    calls = []
    monkeypatch.setattr(sim, "_forces", lambda *a: calls.append(a) or (
        None,) * 4)
    state = sim.init_state(pos, box)
    assert len(calls) == 1 and sim._roll_grid.cap < 100
    sim._regrow(state, {"roll": 254})
    assert sim._roll_grid.cap == 256
    with pytest.raises(ValueError, match=r"angular_fwd: grid cap 260 above "
                       r"256"):
        sim._regrow(state, {"roll": 258})
    assert len(calls) == 1
