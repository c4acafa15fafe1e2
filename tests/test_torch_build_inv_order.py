"""The arithmetic of the build_inv kernel (lammps_ani_torch/csrc/
aev_asn.cu, `asn_build_inv_kernel`), transcribed in torch and held against
the plain version and the JAX package's `build_assignment` (its Pallas
kernels in interpret mode). chip_smoke.py holds the kernel itself against
the plain version on the card.

The kernel runs one block per bin. The block stages the bin's 27-bin
window once: each offset's first grid slot and wrap shift (once per
offset, not per lane), the shifted position of every window lane
(candidate_pos: owner + sx h0, then + sy h1, then + sz h2, each product
exact) and its species, -1 for a species no section keeps; then it
compacts the window in lane order to the lanes of a kept species. Its
warps take the rows in turn: a row with no atom is kpad - 1 everywhere;
otherwise the compacted window is read 32 lanes at a time and each
section's lanes within the keep radius (self excluded) are ranked by a
ballot and the popcount of the lanes below, plus the section's carry from
the earlier chunks, and scattered to their window lanes in a row of
kpad - 1. ovf[s] is the largest count_s - k_s over the rows (an empty row
counts 0).

System: WATER30 x 3^3 (810 atoms, 24 A box), jittered by a seeded normal
(0.05 A), sorted by species; one coarse roll grid of bin side >= Rcr +
skin = 7.1 A at cap 40 (3 x 3 x 3 bins, 270 empty rows), sections with
the JAX engine's margins and a tight pair of sections that overflows, in
f64 and f32. Tables and overflows must be equal.
"""

import numpy as np
import pytest
import torch

from lammps_ani_tpu.ops import aev_asn as jasn
from lammps_ani_torch.ops import aev_asn as tasn
from lammps_ani_torch.ops import aev_roll as tar

from .test_torch_asn_build import KEEP_R, asn_system, grids, sizing

DTYPES = {"f64": torch.float64, "f32": torch.float32}

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: with several test processes on one machine, each
    with a thread per core, the threads wait on one another at every
    operation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def window_tab(ncells, cap):
    """(first grid slot [NC, 27], wrap shift [NC, 27, 3]) of each bin's
    window offsets, x outermost (the kernel's tab, once per offset)."""
    nx, ny, nz = ncells
    cell = torch.arange(nx * ny * nz)
    idx = (cell // (ny * nz), (cell // nz) % ny, cell % nz)
    base, shift = [], []
    for off in tar._shell_offsets(1):
        j = [i + int(o) for i, o in zip(idx, off)]
        s = [(jj >= n).long() - (jj < 0).long()
             for jj, n in zip(j, ncells)]
        j = [jj - ss * n for jj, ss, n in zip(j, s, ncells)]
        base.append(((j[0] * ny + j[1]) * nz + j[2]) * cap)
        shift.append(torch.stack(s, -1))
    return torch.stack(base, 1), torch.stack(shift, 1)


def stage_window(pos_g, sp_g, h, ncells, keep_species):
    """(positions [NC, W, 3], species [NC, W]) of each bin's staged
    window: the kernel's stage_window."""
    nc, cap = sp_g.shape
    base, shift = window_tab(ncells, cap)
    w = torch.arange(27 * cap)
    o = w // cap
    q = base[:, o] + (w - o * cap)
    p = pos_g.reshape(-1, 3)[q]
    sh = shift[:, o]
    for m in range(3):
        s_m = sh[..., m]
        p = torch.where((s_m != 0)[..., None],
                        p + s_m[..., None].to(p.dtype) * h[m], p)
    ws = sp_g.reshape(-1)[q]
    kept = torch.zeros_like(ws, dtype=torch.bool)
    for s in keep_species:
        kept |= ws == s
    return p, torch.where(kept, ws, -1)


def emulate_build_inv(pos_g, sp_g, h, ncells, sections, kpad, keep_r):
    """(inv, ovf) as the kernel computes them: the staged window compacted
    to the kept species' lanes, empty rows filled, each row ranked 32
    compacted lanes at a time by ballot and popcount with a carry per
    section and scattered to its window lanes."""
    nc, cap = sp_g.shape
    wpad = tasn._round_lane(27 * cap)
    offs, _ = tasn._sec_offsets(sections)
    win_p, win_s = stage_window(pos_g, sp_g, h, ncells,
                                [s for s, _ in sections])
    # the compacted window of each bin, in lane order, padded with -1
    n_kept = (win_s >= 0).sum(1)
    order = torch.argsort((win_s < 0).to(torch.int64), dim=1, stable=True)
    kept_w = torch.where(torch.arange(win_s.shape[1]) < n_kept[:, None],
                         order, -1)
    kept_s = torch.where(kept_w >= 0, torch.gather(win_s, 1, order), -1)
    kept_p = torch.gather(win_p, 1, order[..., None].expand(-1, -1, 3))
    real = (sp_g >= 0)[:, :, None]
    self_lane = 13 * cap + torch.arange(cap)
    r2 = keep_r * keep_r
    inv = torch.full((nc, cap, wpad + 1), kpad - 1, dtype=torch.int16)
    carry = torch.zeros((nc, cap, len(sections)), dtype=torch.int64)
    for base in range(0, int(n_kept.max()), 32):
        lanes = torch.arange(base, min(base + 32, kept_w.shape[1]))
        c = kept_p[:, None, lanes, :]
        ctr = pos_g[:, :, None, :]
        dx, dy, dz = (ctr[..., i] - c[..., i] for i in range(3))
        d2 = (dx * dx + dy * dy) + dz * dz
        w = kept_w[:, None, lanes].expand(-1, cap, -1)
        sw = kept_s[:, None, lanes].expand(-1, cap, -1)
        ok = real & (sw >= 0) & (d2 <= r2) & (w != self_lane[None, :, None])
        sw = torch.where(ok, sw, -1)
        v = torch.full(sw.shape, -1, dtype=torch.int64)
        for si, ((s, _), off) in enumerate(zip(sections, offs)):
            bal = sw == s
            below = torch.cumsum(bal.to(torch.int64), -1) - bal.to(
                torch.int64)
            v = torch.where(bal, off + carry[..., si:si + 1] + below, v)
            carry[..., si] += bal.sum(-1)
        # the scatter: lanes that got a rank write it at their window lane
        # (the others at the spare column wpad, dropped below)
        inv.scatter_(2, torch.where(v >= 0, w, wpad),
                     torch.where(v >= 0, v, kpad - 1).to(torch.int16))
    ovf = torch.full((tasn._MAX_S,), tasn.DEFICIT_FLOOR, dtype=torch.int32)
    for si, (s, k_s) in enumerate(sections):
        ovf[s] = int((carry[..., si] - k_s).max())
    return inv[..., :wpad].contiguous(), ovf


@pytest.fixture(scope="module")
def system():
    species, pos, h, origin = asn_system()
    sections, kpad, _, _ = sizing(species, pos, h)
    return dict(species=species, pos=pos, h=h, origin=origin,
                sections=sections, kpad=kpad)


@pytest.fixture(scope="module", params=sorted(DTYPES))
def case(request, system):
    """Grid inputs, the emulated and plain (inv, ovf), and the JAX
    assignment, at the sized sections and at tight ones (halved)."""
    s = system
    j, t = grids(s["species"], s["pos"], s["h"], s["origin"],
                 DTYPES[request.param])
    pos_g, sp_g = tar._grid_inputs(t["bins"].inv, t["pos"],
                                   t["bins"].species_grid)
    args = (pos_g, sp_g, t["box"].h.contiguous(), t["grid"].ncells)
    out = dict(sp_g=sp_g, kpad=s["kpad"])
    tight = tuple((sp, k // 2) for sp, k in s["sections"])
    for tag, sections in (("sized", s["sections"]), ("tight", tight)):
        out[tag] = dict(
            emulated=emulate_build_inv(*args, sections, s["kpad"], KEEP_R),
            plain=tasn.build_inv_plain(*args, sections, s["kpad"], KEEP_R))
        # the JAX build in interpret mode takes about 10 s: the tight
        # sections against it in f64 only
        if tag == "sized" or request.param == "f64":
            out[tag]["jax"] = jasn.build_assignment(
                j["grid"], j["bins"], j["pos"], j["box"], sections,
                s["kpad"], KEEP_R, interpret=True)
    return out


def test_grid_has_empty_rows(case):
    assert int((case["sp_g"] < 0).sum()) > 0


@pytest.mark.parametrize("tag", ["sized", "tight"])
def test_emulated_inv_equals_plain(case, tag):
    inv, ovf = case[tag]["emulated"]
    inv_p, ovf_p = case[tag]["plain"]
    assert torch.equal(inv, inv_p)
    assert torch.equal(ovf, ovf_p)


@pytest.mark.parametrize("tag", ["sized", "tight"])
def test_emulated_inv_equals_jax(case, tag):
    """The inv table and the per-species overflows equal JAX's (the tight
    sections in f64); the tight sections overflow (their tables still
    agree: the rank past k_s is the same integer on both sides)."""
    inv, ovf = case[tag]["emulated"]
    if tag == "tight" and "jax" not in case[tag]:
        assert int(ovf.max()) > 0
        return
    ja = case[tag]["jax"]
    np.testing.assert_array_equal(inv.numpy(), np.asarray(ja.inv))
    n_sp = len(ja.ovf_sec)
    np.testing.assert_array_equal(ovf[:n_sp].numpy().astype(np.float64),
                                  np.asarray(ja.ovf_sec, np.float64))
    assert (int(ovf.max()) > 0) == (tag == "tight")


def test_empty_rows_are_dead_lanes(case):
    """A row with no atom is kpad - 1 everywhere, in the emulation (the
    kernel fills it without a scan) and in the plain version."""
    empty = case["sp_g"] < 0
    for which in ("emulated", "plain"):
        inv = case["sized"][which][0]
        assert bool((inv[empty] == case["kpad"] - 1).all())


def test_staged_window_keeps_the_candidate_bits(system):
    """The staged window's positions equal the plain version's candidate
    planes bit for bit (the halo copies add the same shifts in the same
    order), so every d2 of the kernel is the plain version's."""
    s = system
    for dtype in DTYPES.values():
        _, t = grids(s["species"], s["pos"], s["h"], s["origin"], dtype)
        pos_g, sp_g = tar._grid_inputs(t["bins"].inv, t["pos"],
                                       t["bins"].species_grid)
        h = t["box"].h.contiguous()
        win_p, win_s = stage_window(pos_g, sp_g, h, t["grid"].ncells, (0, 3))
        cp, cs = tar._candidates(t["grid"].ncells, pos_g, sp_g, h, 1)
        assert torch.equal(win_p, cp)
        assert torch.equal(win_s, torch.where((cs == 0) | (cs == 3), cs, -1))
