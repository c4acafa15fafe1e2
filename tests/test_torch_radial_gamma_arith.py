"""The radial backward as the card computes it (lammps_ani_torch/csrc/
aev_asn.cu, `radial_gamma_row`, shared by `asn_radial_gamma_kernel` and
`asn_radial_bwd_asn_kernel`), transcribed in torch and held against the
plain version (`aev_asn.radial_gamma_plain`):

  * Pass 1 takes every compact lane's geometry and appends the lanes
    within Rcr or the repulsion cutoff to a packed list in ascending lane
    order; pass 2 computes gamma on the packed lanes, 32 at a time; pass 3
    writes gamma (a / d) at every lane, 0 on dead lanes, in the kpad tail
    and on every lane of a row with no atom. One thread computes a lane's
    gamma from that lane's values alone, so the packing order cannot
    change it: the transcription gives the same bits in any order, and in
    f64 the plain version's bits.
  * In f32 the Gaussians are 2^(geta xk^2) with geta = -eta log2(e)
    rounded to f32 (the forward's ex2, tests/test_torch_step_arith.py),
    the cutoff's cosine and sine are the hardware's (absolute error
    2^-21.4 on [-pi, pi]) and the divisions are __fdividef's a x (1 / b).
    ex2 and the reciprocal are taken as exact here (numpy in f64, rounded
    to f32); the hardware cosine's error is applied as a worst-case
    perturbation.

System: WATER30 x 3^3 (810 atoms, 24 A box), jittered, sorted by species,
3^3 bins at cap 40, the sections of tests/test_torch_asn_build.py; ANI-2x
radial terms with the GFN1 repulsion term (cutoff 5.1, smooth envelope).

f32 limit (chip_smoke.py's gate): |err| <= 5e-6 + 1e-5 x the largest
magnitude of the output.
"""

import math

import numpy as np
import pytest
import torch

from lammps_ani_torch.models import aev as taev
from lammps_ani_torch.models import repulsion as trep
from lammps_ani_torch.ops import aev_asn as tasn
from lammps_ani_torch.ops import aev_roll as tar

from .test_torch_asn_build import KEEP_R, asn_system, grids, sizing

SYMBOLS = ("H", "C", "N", "O", "S", "F", "Cl")
F32 = np.float32
LOG2E = 1.4426950408889634
HW_TRIG_ERR = 2.0 ** -21.41  # __cosf / __sinf on [-pi, pi] (CUDA guide)

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


@pytest.fixture(scope="module")
def system():
    """Per dtype: the grid inputs, the rebuild's idx, seeded cotangents
    (normal and integer-valued) and the plain version's output."""
    species, pos, h, origin = asn_system()
    sections, kpad, _, _ = sizing(species, pos, h)
    spec = taev.ani2x_aev_spec()
    rep = trep.RepulsionSpec.for_symbols(SYMBOLS, cutoff=5.1)
    out = {"sections": sections, "kpad": kpad, "spec": spec, "rep": rep}
    rng = np.random.default_rng(11)
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        _, t = grids(species, pos, h, origin, dtype)
        a = tasn.build_assignment(t["grid"], t["bins"], t["pos"], t["box"],
                                  sections, kpad, KEEP_R)
        assert float(a.ovf) <= 0
        pos_g, sp_g = tar._grid_inputs(t["bins"].inv, t["pos"],
                                       t["bins"].species_grid)
        nc, cap = sp_g.shape
        srl1 = len(sections) * 16 + 1
        ga = torch.tensor(rng.standard_normal((nc, cap, srl1)), dtype=dtype)
        ga_int = torch.tensor(rng.integers(-8, 9, (nc, cap, srl1)),
                              dtype=dtype)
        args = dict(pos_g=pos_g, sp_g=sp_g, h=t["box"].h, idx=a.idx,
                    ncells=t["grid"].ncells)
        plain = {key: tasn.radial_gamma_plain(
            pos_g, sp_g, t["box"].h, a.idx, g, t["grid"].ncells, spec,
            sections, rep) for key, g in (("normal", ga), ("int", ga_int))}
        out[name] = dict(args=args, ga={"normal": ga, "int": ga_int},
                         plain=plain)
    return out


def kernel_radial_gamma(s, dtype_name, which, order_seed=None,
                        trig_err=0.0):
    """gr [NC, cap, 3, kpad] as the kernel computes it. Pass 2 runs over
    the packed lanes 32 at a time, in row and ascending lane order, or in
    an order shuffled by `order_seed`. `trig_err` is added to the
    f32 cosine and subtracted from the sine."""
    d = s[dtype_name]
    pos_g, sp_g, h, idx = (d["args"][key] for key in ("pos_g", "sp_g", "h",
                                                      "idx"))
    ga = d["ga"][which]
    f32 = dtype_name == "f32"
    dtype = pos_g.dtype
    spec, rep, sections = s["spec"], s["rep"], s["sections"]
    nc, cap = sp_g.shape
    kpad = idx.shape[-1]
    wpad = tasn._round_lane(27 * cap)
    k = tasn._step_consts(spec, dtype)
    rc, eta, mu0, delta, nr = (k["rc"], k["eta"], k["mu0"], k["delta"],
                               k["nr"])
    T = (lambda v: torch.tensor(v, dtype=dtype))

    # pass 1: the lane geometry (a dead lane: a = 0, dist 1e6)
    cp = tasn._padded_candidates(d["args"]["ncells"], pos_g, sp_g, h, wpad)
    ax, ay, az, valid, dist = tasn._lane_geometry(cp, pos_g,
                                                  idx.to(torch.int64), wpad)
    ax, ay, az = (torch.where(valid, v, 0.0) for v in (ax, ay, az))
    rows = nc * cap
    ax, ay, az, valid, dist = (v.reshape(rows, kpad)
                               for v in (ax, ay, az, valid, dist))
    offs, k_total = tasn._sec_offsets(sections)
    lane = torch.arange(kpad)
    si = torch.bucketize(lane, torch.tensor(offs[1:]), right=True)
    # repulsion pair parameters of (center, section), as section_rep
    csp = sp_g.reshape(rows).to(torch.int64)
    a_c = torch.zeros(rows, dtype=dtype)
    z_c = torch.zeros(rows, dtype=dtype)
    for sp_s, _ in sections:
        a_c = torch.where(csp == sp_s, T(rep.alpha[sp_s]), a_c)
        z_c = torch.where(csp == sp_s, T(rep.zeff[sp_s]), z_c)
    alpha_s = T([rep.alpha[sp_s] for sp_s, _ in sections])
    zeff_s = T([rep.zeff[sp_s] for sp_s, _ in sections])
    a_ij = torch.sqrt(torch.clamp(alpha_s[None, :] * a_c[:, None],
                                  min=1e-12))
    z_ij = zeff_s[None, :] * z_c[:, None]
    z_lane = z_ij[:, si]
    in_sec = lane < k_total
    m = (valid & in_sec[None, :]
         & ((dist <= rc) | ((z_lane > 0) & (dist < rep.cutoff))))
    m &= (csp >= 0)[:, None]

    # the packed list: (row, lane) in ascending lane order, per row
    r_e, k_e = torch.nonzero(m, as_tuple=True)
    if order_seed is not None:
        perm = torch.tensor(np.random.default_rng(order_seed).permutation(
            r_e.numel()))
        r_e, k_e = r_e[perm], k_e[perm]

    # pass 2, 32 entries at a time, into the gamma buffer
    sgam = torch.zeros((rows, kpad), dtype=dtype)
    g_rows = ga.reshape(rows, -1)
    pi_rc, dfc_rk = T(math.pi / rc), T(-0.5 * math.pi / rc)
    geta = T(-eta * LOG2E) if f32 else T(-eta)
    two_eta = T(2.0) * T(eta)
    for lo in range(0, r_e.numel(), 32):
        r, kk_lane = r_e[lo:lo + 32], k_e[lo:lo + 32]
        dd = dist[r, kk_lane]
        sec = si[kk_lane]
        gamma = torch.zeros_like(dd)
        arg = dd * pi_rc
        if f32:
            cos = (torch.cos(arg.double()) + trig_err).to(dtype)
            sin = (torch.sin(arg.double()) - trig_err).to(dtype)
        else:
            cos, sin = torch.cos(arg), torch.sin(arg)
        fc = T(0.5) * cos + T(0.5)
        dfc = dfc_rk * sin
        x = dd - T(mu0)
        inc = dd <= rc
        for kk in range(nr):
            xk = x - T(float(kk)) * T(delta)
            y = (geta * xk) * xk
            e = (torch.exp2(y.double()).to(dtype) if f32 else torch.exp(y))
            e = torch.where(e > k["tiny"], e, 0.0)
            term = g_rows[r, sec * nr + kk] * (T(0.25) * e
                                               * (dfc - two_eta * xk * fc))
            gamma = torch.where(inc, gamma + term, gamma)
        inr = (z_ij[r, sec] > 0) & (dd < rep.cutoff)
        gamma = torch.where(inr, gamma + g_rows[r, -1] * rep_grad(
            rep, dd, a_ij[r, sec], z_ij[r, sec], f32), gamma)
        sgam[r, kk_lane] = gamma

    # pass 3: gamma / d (f32: a x (1 / b)) times a
    if f32:
        gd = sgam * (1.0 / dist.double()).to(dtype)
    else:
        gd = sgam / dist
    gd = torch.where(in_sec[None, :], gd, 0.0)
    out = torch.stack([gd * ax, gd * ay, gd * az], dim=1)
    out = torch.where((csp >= 0)[:, None, None], out, 0.0)
    return out.reshape(nc, cap, 3, kpad)


def rep_grad(rep, dist, a_ij, z_ij, f32):
    """`rep_half_grad` (smooth envelope): f32 divides as a x (1 / b)."""
    dtype = dist.dtype

    def q(a, b):
        if f32:
            return a * (1.0 / b.double()).to(dtype)
        return a / b

    def t(v):
        return torch.tensor(v, dtype=dtype)

    a2b = t(1.8897261258369282)
    rc = torch.full_like(dist, rep.cutoff)
    r_b = dist * a2b
    r_kf = r_b * torch.sqrt(r_b)
    core = q(z_ij, r_b) * torch.exp(-a_ij * r_kf)
    dcore = core * (q(torch.full_like(r_b, -1.0), r_b)
                    - q(a_ij * t(rep.k_f) * r_kf, r_b))
    x = q(dist, rc)
    x2 = torch.clamp(x * x, 0.0, float(t(1.0 - 1e-6)))
    u = 1.0 - x2
    env = torch.exp(1.0 - q(torch.ones_like(u), u))
    denv = env * q(t(-2.0) * x, rc * u * u)
    return t(0.5) * (dcore * a2b * env + core * denv)


@pytest.mark.parametrize("which", ["normal", "int"])
def test_f64_transcription_equals_the_plain_version(system, which):
    """f64: the kernel's three passes give the plain version's bits on
    every lane (normal and integer-valued cotangents)."""
    got = kernel_radial_gamma(system, "f64", which)
    want = system["f64"]["plain"][which]
    assert want.abs().max() > 0.1
    assert torch.equal(got, want)


@pytest.mark.parametrize("order_seed", [1, 2])
@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
def test_packing_order_does_not_change_gamma(system, order_seed,
                                             dtype_name):
    """Pass 2 over the packed lanes in a shuffled order (other lanes
    beside each other in the 32-wide groups) gives the same bits."""
    base = kernel_radial_gamma(system, dtype_name, "normal")
    shuffled = kernel_radial_gamma(system, dtype_name, "normal",
                                   order_seed=order_seed)
    bits = torch.int64 if dtype_name == "f64" else torch.int32
    assert torch.equal(base.view(bits), shuffled.view(bits))


@pytest.mark.parametrize("trig_err", [0.0, HW_TRIG_ERR, -HW_TRIG_ERR])
def test_f32_transcription_within_the_gate(system, trig_err):
    """f32: the kernel's arithmetic (ex2 Gaussians, hardware cosine and
    sine at their worst-case error, __fdividef) against the plain version
    in f32 within 0.1 of the gate, and against the f64 plain version no
    worse than the plain f32 version is, plus 0.05 of the gate."""
    got = kernel_radial_gamma(system, "f32", "normal", trig_err=trig_err)
    want = system["f32"]["plain"]["normal"]
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= 0.1 * gate(scale), (err, gate(scale))
    ref = system["f64"]["plain"]["normal"]
    lim = gate(float(ref.abs().max()))
    err64 = float((got.double() - ref).abs().max())
    err_plain = float((want.double() - ref).abs().max())
    assert err64 <= err_plain + 0.05 * lim, (err64, err_plain, lim)


def derivative_terms(d, kk, form, trig_err=0.0):
    """0.25 e (dfc - 2 eta xk fc) of shift kk at distances d in [0, Rcr]:
    form "ex2", in f32 as the kernel computes it; "expf", in f32 with
    exp(-eta xk^2) exactly rounded (an expf Gaussian, as the plain f32
    version computes it); "f64"."""
    rc, eta, mu0, delta, _ = tar.radial_consts(taev.ani2x_aev_spec())
    if form == "f64":
        d = d.astype(np.float64)
        arg = d * (math.pi / rc)
        fc = 0.5 * np.cos(arg) + 0.5
        dfc = (-0.5 * math.pi / rc) * np.sin(arg)
        xk = d - mu0 - kk * delta
        e = np.exp(-eta * xk * xk)
        return 0.25 * e * (dfc - 2.0 * eta * xk * fc)
    arg = (d * F32(math.pi / rc)).astype(np.float64)
    fc = F32(0.5) * (np.cos(arg) + trig_err).astype(F32) + F32(0.5)
    dfc = F32(-0.5 * math.pi / rc) * (np.sin(arg) - trig_err).astype(F32)
    xk = (d - F32(mu0)) - F32(kk) * F32(delta)
    if form == "ex2":
        y = (F32(-eta * LOG2E) * xk) * xk
        e = np.exp2(y.astype(np.float64)).astype(F32)
    else:
        y = (F32(-eta) * xk) * xk
        e = np.exp(y.astype(np.float64)).astype(F32)
    e = np.where(e > F32(1e-30), e, F32(0))
    return F32(0.25) * e * (dfc - (F32(2) * F32(eta)) * xk * fc)


@pytest.mark.parametrize("trig_err", [0.0, HW_TRIG_ERR, -HW_TRIG_ERR])
def test_f32_ex2_derivative_term_against_f64(trig_err):
    """Each shift's f32 derivative term over d in [0, Rcr] against f64.
    The worst absolute error over the 16 shifts, as a fraction of the
    gate at the terms' largest magnitude (0.898): 0.0601 for the ex2 form
    and for the expf form alike (the f32 rounding of xk sets it), 0.0657
    and 0.0586 with the hardware cosine and sine at their worst error
    either way. Bound: under 0.1 of the gate, and within 0.01 of the gate
    of the expf form's worst."""
    rc = tar.radial_consts(taev.ani2x_aev_spec())[0]
    d = np.linspace(0.0, rc, 100001).astype(F32)
    worst = {"ex2": 0.0, "expf": 0.0}
    scale = 0.0
    for kk in range(16):
        ref = derivative_terms(d, kk, "f64")
        scale = max(scale, float(np.abs(ref).max()))
        for form in worst:
            got = derivative_terms(d, kk, form,
                                   trig_err if form == "ex2" else 0.0)
            worst[form] = max(worst[form], float(np.abs(got - ref).max()))
    lim = gate(scale)
    assert scale > 0.5
    assert worst["ex2"] <= 0.1 * lim, (worst["ex2"] / lim, scale)
    assert worst["ex2"] <= worst["expf"] + 0.01 * lim, (worst, lim)


def test_rows_without_an_atom_and_dead_lanes_give_exact_zeros(system):
    """The plain version (which the kernel's shortcut for a row with no
    atom relies on) is exactly 0 on every lane of an empty grid slot and
    on every dead lane, and nonzero elsewhere; so is the kernel's
    transcription."""
    for name in ("f64", "f32"):
        d = system[name]
        sp_g, idx = d["args"]["sp_g"], d["args"]["idx"]
        cap = sp_g.shape[1]
        empty = (sp_g < 0)[:, :, None, None]
        dead = (idx.to(torch.int64) >= 27 * cap)[:, :, None, :]
        assert empty.any() and dead.any()
        for gr in (d["plain"]["normal"],
                   kernel_radial_gamma(system, name, "normal")):
            assert not gr[(empty | dead).expand_as(gr)].any()
            assert gr.abs().max() > 0
        # an empty slot keeps no lane (build_inv), so its idx is all dead
        assert bool(dead[empty[:, :, 0, 0]].all())
