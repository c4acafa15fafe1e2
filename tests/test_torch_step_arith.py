"""The arithmetic of the step forward's radial columns as the card computes
them (lammps_ani_torch/csrc/aev_asn.cu, `radial_cols_lane` and the end of
`step_row`, shared by `asn_step_fused_kernel` and
`asn_radial_fwd_asn_kernel`), transcribed in numpy and held against f64:

  * f32 Gaussians as 2^(geta xk^2) with geta = -eta log2(e) rounded to
    f32, in place of expf(-eta xk^2). The card's ex2.approx is taken as
    exact here (numpy's exp2 in f64, rounded to f32), as
    tests/test_torch_packed_live.py takes the power's lg2 and ex2; its own
    error is 2 ulp (PTX ISA), far under what f32 rounding of the argument
    gives near the 1e-30 flush.
  * The 16 column sums of a section by one reduce-scatter over the warp's
    32 lanes (`reduce_scatter16`): four exchange steps of width 8, 4, 2, 1,
    then one add across the half-warps.
  * The whole, in f32: a section's lanes within Rcr packed in ascending
    lane order into groups of 32, each warp lane's terms summed over the
    groups in order, then the reduce-scatter; on the lanes of WATER30 x
    3^3 (810 atoms, 24 A box, the system of tests/test_torch_asn_build.py)
    against the plain version in f32 and in f64.

f32 limit (chip_smoke.py's gate): |err| <= 5e-6 + 1e-5 x the largest
magnitude of the output.
"""

import math

import numpy as np
import pytest
import torch

from lammps_ani_torch.models import aev as taev
from lammps_ani_torch.ops import aev_asn as tasn
from lammps_ani_torch.ops import aev_roll as tar

from .test_torch_asn_build import KEEP_R, asn_system, grids, sizing

F32 = np.float32
LOG2E = 1.4426950408889634
TINY = F32(1e-30)

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


def radial_consts():
    return tar.radial_consts(taev.ani2x_aev_spec())  # rc eta mu0 delta nr


def gauss_ex2(d, kk, eta, mu0, delta):
    """The kernel's f32 basis value of shift kk at f32 distances d: x = d -
    mu0, xk = x - kk delta, e = 2^((geta xk) xk), flushed below 1e-30."""
    xk = (d - F32(mu0)) - F32(kk) * F32(delta)
    y = (F32(-eta * LOG2E) * xk) * xk
    e = np.exp2(y.astype(np.float64)).astype(F32)
    return np.where(e > TINY, e, F32(0))


def gauss_expf(d, kk, eta, mu0, delta):
    """The parent kernel's form: expf((-eta xk) xk) (exact exp, rounded)."""
    xk = (d - F32(mu0)) - F32(kk) * F32(delta)
    y = (F32(-eta) * xk) * xk
    e = np.exp(y.astype(np.float64)).astype(F32)
    return np.where(e > TINY, e, F32(0))


@pytest.fixture(scope="module")
def basis():
    """f32 distances over the basis's range (0 to Rcr) and, per shift, the
    ex2 form, the expf form and the f64 reference."""
    rc, eta, mu0, delta, nr = radial_consts()
    d = np.linspace(0.0, rc, 200001).astype(F32)
    out = []
    for kk in range(nr):
        ref = np.exp(-eta * (d.astype(np.float64) - mu0 - kk * delta) ** 2)
        out.append((gauss_ex2(d, kk, eta, mu0, delta),
                    gauss_expf(d, kk, eta, mu0, delta), ref))
    return d, out


@pytest.mark.parametrize("kk", range(16))
def test_ex2_gaussian_within_the_f32_gate(basis, kk):
    """Each shift's f32 basis value against f64 exp over d in [0, Rcr]:
    the absolute error within 0.15 of the gate at scale 1 (the largest
    basis value); relative error, where the reference is above the flush,
    under 3e-5 (worst of all shifts: 2.6e-5, all of it the f32 rounding
    of xk and of the argument, which grows with |argument| up to the
    flush at 2^-99.7; the expf form is 2.9e-5 there)."""
    _, per_shift = basis
    e, _, ref = per_shift[kk]
    live = ref > 1e-30
    assert (e[~live] <= 1e-29).all()
    abs_err = np.abs(e - np.where(live, ref, 0.0)).max()
    assert abs_err <= 0.15 * gate(1.0), abs_err
    rel = (np.abs(e[live] - ref[live]) / ref[live]).max()
    assert rel < 3e-5, rel


def test_ex2_form_is_as_accurate_as_the_expf_form(basis):
    """Over every shift, the ex2 form's worst error against f64 is no
    worse than the expf form's by more than geta's one rounding (6e-8 of
    an argument of at most 100, 1 part in 10^5 of the flush's value)."""
    _, per_shift = basis
    worst = {"ex2": 0.0, "expf": 0.0}
    for e2, ef, ref in per_shift:
        live = ref > 1e-30
        for name, e in (("ex2", e2), ("expf", ef)):
            err = np.abs(e[live] - ref[live]) / ref[live]
            worst[name] = max(worst[name], float(err.max()))
    assert worst["ex2"] <= worst["expf"] + 1e-5, worst


def reduce_scatter16(acc):
    """The kernel's `reduce_scatter16` on acc [32 lanes, 16 columns], lane
    by lane as the shuffles run: returns [32], lane l's result."""
    acc = acc.copy()
    lanes = np.arange(32)
    for w in (8, 4, 2, 1):
        upper = (lanes & w) != 0
        new = acc.copy()
        for i in range(w):
            send = np.where(upper, acc[:, i], acc[:, i + w])
            keep = np.where(upper, acc[:, i + w], acc[:, i])
            new[:, i] = keep + send[lanes ^ w]
        acc = new
    return acc[:, 0] + acc[lanes ^ 16, 0]


@pytest.mark.parametrize("seed", range(4))
def test_reduce_scatter16_gives_each_column_sum(seed):
    """f64: lane l ends with column l & 15 summed over the 32 lanes, to
    1e-15 of the column's magnitude sum; lanes l and l + 16 hold the same
    bits."""
    acc = np.random.default_rng(seed).standard_normal((32, 16))
    got = reduce_scatter16(acc)
    want = acc.sum(0)
    scale = np.abs(acc).sum(0)
    for lane in range(32):
        col = lane & 15
        assert abs(got[lane] - want[col]) <= 1e-15 * scale[col]
    assert np.array_equal(got[:16].view(np.int64), got[16:].view(np.int64))


def test_reduce_scatter16_zero_columns_stay_zero():
    """Columns past NR (zero on every lane) sum to exactly +0."""
    acc = np.zeros((32, 16))
    acc[:, :10] = np.random.default_rng(9).standard_normal((32, 10))
    got = reduce_scatter16(acc)
    lanes = np.arange(32)
    zero = (lanes & 15) >= 10
    assert (got[zero] == 0).all() and not np.signbit(got[zero]).any()


@pytest.fixture(scope="module")
def lanes():
    """The f32 lane distances of the sized 810-atom system ([rows, kpad],
    dead lanes at 1e6), its sections, and the plain radial columns in
    f64."""
    species, pos, h, origin = asn_system()
    sections, kpad, _, _ = sizing(species, pos, h)
    out = {"sections": sections, "kpad": kpad}
    spec = taev.ani2x_aev_spec()
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        _, t = grids(species, pos, h, origin, dtype)
        a = tasn.build_assignment(t["grid"], t["bins"], t["pos"], t["box"],
                                  sections, kpad, KEEP_R)
        assert float(a.ovf) <= 0
        pos_g, sp_g = tar._grid_inputs(t["bins"].inv, t["pos"],
                                       t["bins"].species_grid)
        ncells = t["grid"].ncells
        wpad = a.inv.shape[-1]
        cp = tasn._padded_candidates(ncells, pos_g, sp_g, t["box"].h, wpad)
        *_, dist = tasn._lane_geometry(cp, pos_g, a.idx.to(torch.int64),
                                       wpad)
        rad = tasn.radial_fwd_asn_plain(pos_g, sp_g, t["box"].h, a.idx,
                                        ncells, spec, sections, None)
        out[name] = dict(dist=dist.reshape(-1, kpad).numpy(),
                         rad=rad.reshape(-1, rad.shape[-1]).numpy())
    return out


def kernel_radial_f32(dist, sections):
    """[rows, 16 x sections]: the kernel's f32 radial columns of each row.
    Per section, the lanes within Rcr are packed in ascending lane order
    (entry i of the packed list is the i-th such lane); warp lane l adds
    the terms of entries l, l + 32, ... in that order, then
    `reduce_scatter16` sums over the warp."""
    rc, eta, mu0, delta, nr = radial_consts()
    d = dist.astype(F32)
    inc = d <= F32(rc)
    pref = F32(0.25) * (F32(0.5) * np.cos(d * F32(math.pi / rc)).astype(F32)
                        + F32(0.5))
    terms = np.zeros(d.shape + (16,), F32)
    for kk in range(nr):
        t = pref * gauss_ex2(d, kk, eta, mu0, delta)
        terms[..., kk] = np.where(inc & (t > TINY), t, F32(0))
    rows = np.arange(d.shape[0])
    lanes = np.arange(32)
    cols, off = [], 0
    for _, k_s in sections:
        m = inc[:, off:off + k_s]
        rank = np.cumsum(m, axis=1) - 1  # packed entry of each lane
        acc = np.zeros((d.shape[0], 32, 16), F32)
        for group in range(-(-k_s // 32)):
            r, k = np.nonzero(m & (rank // 32 == group))
            # one entry per (row, warp lane) in a group
            acc[r, rank[r, k] % 32] += terms[r, off + k]
        for w in (8, 4, 2, 1):
            upper = ((lanes & w) != 0)[None, :]
            new = acc.copy()
            for i in range(w):
                send = np.where(upper, acc[:, :, i], acc[:, :, i + w])
                keep = np.where(upper, acc[:, :, i + w], acc[:, :, i])
                new[:, :, i] = keep + send[:, lanes ^ w]
            acc = new
        cols.append((acc[:, :, 0] + acc[:, lanes ^ 16, 0])[rows][:, :16])
        off += k_s
    return np.concatenate(cols, axis=1)


def test_kernel_radial_columns_match_the_plain_f32(lanes):
    """The kernel's f32 radial columns, transcribed, on the f32 lanes of
    the 810-atom system against the plain version in f32 (torch's exp and
    its own sum order): within 0.1 of the f32 gate at the output's scale
    (observed 0.025)."""
    got = kernel_radial_f32(lanes["f32"]["dist"], lanes["sections"])
    want = lanes["f32"]["rad"][:, :got.shape[1]]
    scale = float(np.abs(want).max())
    assert scale > 0.1
    err = float(np.abs(got - want).max())
    assert err <= 0.1 * gate(scale), (err, gate(scale))


def test_kernel_radial_columns_against_f64(lanes):
    """...and against the plain version in f64 on the f64 lanes: no worse
    than the plain f32 version is there (0.233 of the gate for both: the
    f32 positions' rounding, not the kernel's arithmetic, sets it), and
    under 0.5 of the gate."""
    got = kernel_radial_f32(lanes["f32"]["dist"], lanes["sections"])
    want = lanes["f64"]["rad"][:, :got.shape[1]]
    plain32 = lanes["f32"]["rad"][:, :got.shape[1]]
    lim = gate(float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    err_plain = float(np.abs(plain32 - want).max())
    assert err <= err_plain + 0.05 * lim, (err, err_plain, lim)
    assert err <= 0.5 * lim, (err, lim)
