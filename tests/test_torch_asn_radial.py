"""The port's per-channel radial surface (`radial_aev_asn`: radial_fwd_asn,
radial_bwd_asn and wing through their plain versions, and the glue between
them) vs the JAX package's `radial_aev_asn` in interpret mode, vs autograd,
vs the fused op and vs the generic AEV oracle.

System and sizing as test_torch_asn_build.py (810 atoms, 3x3x3 coarse bins,
H and O sections); both sides build the assignment from the same sections
and the tables are compared exactly first. A second system relabels the last
60 hydrogens as carbon, a species no section holds: its lanes are dropped and
its columns stay zero, while its atoms are centers like any other. Cases
(the JAX outputs are computed once per module):

  full          full column layout (7 x 16), XTB repulsion
  compact_nout  compact columns (2 x 16), repulsion, rows of the first 500
                atoms only
  norep         full layout without the repulsion term
  third         the relabeled system, full layout, repulsion
  f32           full layout, repulsion, float32

Tolerances: forward f64 1e-12 of the largest entry, f32 atol 5e-6 rtol 1e-5;
(dpos, dh) vs `jax.vjp` 1e-11 of the largest entry, vs autograd through the
plain forward (`plain=True`) 1e-12 of the largest entry (f32: 2e-6, sums
taken in another order); against `aev_asn_fused` the forward is equal bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ani_tpu.models import aev as jaev
from lammps_ani_tpu.models import repulsion as jrep
from lammps_ani_tpu.ops import aev_asn as jasn
from lammps_ani_tpu.ops import neighbors as jnb
from lammps_ani_torch.models import aev as taev
from lammps_ani_torch.models import repulsion as trep
from lammps_ani_torch.ops import aev_asn as tasn
from lammps_ani_torch.ops import aev_roll as tar
from lammps_ani_torch.ops import neighbors as tnb
from lammps_ani_torch.ops.neighbors import Box

from .test_torch_asn_build import (KEEP_R, asn_system, build_both, grids,
                                   sizing)

SYMBOLS = ("H", "C", "N", "O", "S", "F", "Cl")
N_OUT = 500
# name: (system, repulsion, compact_cols, n_out, dtype)
CASES = {"full": ("water", True, False, None, torch.float64),
         "compact_nout": ("water", True, True, N_OUT, torch.float64),
         "norep": ("water", False, False, None, torch.float64),
         "third": ("third", True, False, None, torch.float64),
         "f32": ("water", True, False, None, torch.float32)}
VJP_CASES = ("full", "compact_nout")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions are chains of small tensor operations; one
    thread keeps this file's time flat when several test processes share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_asn(ta):
    return jasn.Assignment(idx=jnp.asarray(ta.idx.numpy()),
                           inv=jnp.asarray(ta.inv.numpy()),
                           ovf=jnp.asarray(float(ta.ovf)),
                           ovf_sec=jnp.asarray(ta.ovf_sec.numpy()))


def _port(s, t, ta, case, pos=None, box=None, plain=False):
    _, rep, compact, n_out, _ = CASES[case]
    return tasn.radial_aev_asn(
        s["tspec"], t["grid"], t["bins"], ta, t["pos"] if pos is None else pos,
        t["box"] if box is None else box, s["sections"],
        repulsion=s["trs"] if rep else None, n_out=n_out,
        compact_cols=compact, plain=plain)


def _port_grads(s, t, ta, case, cots, plain, dtype=torch.float64):
    pos = t["pos"].clone().requires_grad_(True)
    h = t["box"].h.clone().requires_grad_(True)
    out = _port(s, t, ta, case, pos, Box(h=h, origin=t["box"].origin), plain)
    e = sum((o * torch.tensor(c, dtype=dtype)).sum()
            for o, c in zip(out, cots))
    dpos, dh = torch.autograd.grad(e, (pos, h))
    return dpos.numpy(), dh.numpy()


@pytest.fixture(scope="module")
def rad():
    species, pos, h, origin = asn_system()
    sections, kpad, caps, _ = sizing(species, pos, h)
    third = species.copy()
    third[np.nonzero(species == 0)[0][-60:]] = 1  # stays sorted: H, C, O
    s = dict(species=species, third=third, pos=pos, h=h, origin=origin,
             sections=sections, kpad=kpad, caps=caps,
             jspec=jaev.ani2x_aev_spec(), tspec=taev.ani2x_aev_spec(),
             jrs=jrep.RepulsionSpec.for_symbols(SYMBOLS, cutoff=5.1),
             trs=trep.RepulsionSpec.for_symbols(SYMBOLS, cutoff=5.1))
    sysm = {}
    j, t = grids(species, pos, h, origin)
    ja, ta = build_both(j, t, sections, kpad)
    sysm["water", torch.float64] = (j, t, ja, ta)
    j32, t32 = grids(species, pos, h, origin, torch.float32)
    sysm["water", torch.float32] = (j32, t32, ja, ta)
    j3, t3 = grids(third, pos, h, origin)
    ta3 = tasn.build_assignment(t3["grid"], t3["bins"], t3["pos"], t3["box"],
                                sections, kpad, KEEP_R)
    sysm["third", torch.float64] = (j3, t3, _jax_asn(ta3), ta3)
    s["sys"] = sysm

    ref, got, vjp_ref, cots = {}, {}, {}, {}
    rng = np.random.default_rng(11)
    for case, (name, rep, compact, n_out, dtype) in CASES.items():
        j, t, ja, ta = sysm[name, dtype]

        def f(p, hh, j=j, ja=ja, rep=rep, compact=compact, n_out=n_out):
            return jasn.radial_aev_asn(
                s["jspec"], j["grid"], j["bins"], ja, p,
                jnb.Box(h=hh, origin=j["box"].origin), sections,
                repulsion=s["jrs"] if rep else None, interpret=True,
                n_out=n_out, compact_cols=compact)

        if case in VJP_CASES:
            out, vjp = jax.vjp(f, j["pos"], j["box"].h)
            cots[case] = [rng.standard_normal(o.shape) for o in out]
            vjp_ref[case] = [np.asarray(x) for x in vjp(
                tuple(jnp.asarray(c) for c in cots[case]))]
        else:
            out = f(j["pos"], j["box"].h)
        ref[case] = [np.asarray(o) for o in out]
        got[case] = [o.numpy() for o in _port(s, t, ta, case)]
    s.update(ref=ref, got=got, vjp_ref=vjp_ref, cots=cots)
    return s


def _system_of(s, case):
    name, _, _, _, dtype = CASES[case]
    return s["sys"][name, dtype]


@pytest.mark.parametrize("table", ["idx", "inv"])
def test_assignment_tables_equal_jax(rad, table):
    """Both sides built their assignment from the same sections: the tables
    the outputs below rest on are equal."""
    _, _, ja, ta = rad["sys"]["water", torch.float64]
    np.testing.assert_array_equal(getattr(ta, table).numpy(),
                                  np.asarray(getattr(ja, table)))


@pytest.mark.parametrize("quantity", [0, 1], ids=["radial", "erep"])
@pytest.mark.parametrize("case", list(CASES))
def test_radial_forward_matches_jax(rad, case, quantity):
    r, g = rad["ref"][case][quantity], rad["got"][case][quantity]
    _, rep, compact, n_out, dtype = CASES[case]
    n = n_out or len(rad["species"])
    assert g.shape == r.shape == ((n, 32 if compact else 112) if quantity == 0
                                  else (n,))
    if quantity == 1 and not rep:
        assert not g.any() and not r.any()
        return
    assert np.abs(r).max() > 0
    if dtype == torch.float32:
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, r, atol=5e-6, rtol=1e-5)
    else:
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-12 * np.abs(r).max())


@pytest.mark.parametrize("which", [0, 1], ids=["dpos", "dh"])
@pytest.mark.parametrize("case", VJP_CASES)
def test_radial_backward_matches_jax_vjp(rad, case, which):
    """(dpos, dh) for seeded normal cotangents on both outputs (radial and
    erep) vs `jax.vjp` of the JAX function: 1e-11 of the largest entry."""
    _, t, _, ta = _system_of(rad, case)
    g = _port_grads(rad, t, ta, case, rad["cots"][case], plain=False)[which]
    r = rad["vjp_ref"][case][which]
    assert g.shape == r.shape and np.abs(r).max() > 1.0
    np.testing.assert_allclose(g, r, rtol=0, atol=1e-11 * np.abs(r).max())


@pytest.mark.parametrize("which", [0, 1], ids=["dpos", "dh"])
@pytest.mark.parametrize("case", list(CASES))
def test_radial_backward_matches_autograd_through_plain_forward(rad, case,
                                                                which):
    """The explicit backward (radial_bwd_asn, wing, fold) vs autograd
    through `plain=True`, which never touches it."""
    _, t, _, ta = _system_of(rad, case)
    dtype = CASES[case][4]
    cots = [np.random.default_rng(3).standard_normal(o.shape)
            for o in rad["got"][case]]
    g = _port_grads(rad, t, ta, case, cots, False, dtype)[which]
    r = _port_grads(rad, t, ta, case, cots, True, dtype)[which]
    tol = 1e-12 if dtype == torch.float64 else 2e-6
    assert np.abs(r).max() > 0
    np.testing.assert_allclose(g, r, rtol=0, atol=tol * np.abs(r).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_radial_forward_equals_fused_bit_for_bit(rad, dtype):
    """`radial_aev_asn(compact_cols=True)` runs the radial half of the
    fused step on the same lanes in the same order."""
    _, t, _, ta = rad["sys"]["water", dtype]
    head = (rad["tspec"], t["grid"], t["bins"], ta, t["pos"], t["box"],
            rad["sections"])
    for n_out in (None, N_OUT):
        fused = tasn.aev_asn_fused(*head, rad["caps"], repulsion=rad["trs"],
                                   n_out=n_out)
        alone = tasn.radial_aev_asn(*head, repulsion=rad["trs"], n_out=n_out,
                                    compact_cols=True)
        assert torch.equal(alone[0], fused[0])
        assert torch.equal(alone[1], fused[1])


def test_full_layout_places_the_compact_columns(rad):
    """Full layout: section (s, k) sits at columns s*16 .. s*16+15, every
    other column is exactly zero; the relabeled carbons' block stays zero
    although carbon atoms are there."""
    _, t, _, ta = rad["sys"]["third", torch.float64]
    head = (rad["tspec"], t["grid"], t["bins"], ta, t["pos"], t["box"],
            rad["sections"])
    full, e_f = tasn.radial_aev_asn(*head, repulsion=rad["trs"])
    comp, e_c = tasn.radial_aev_asn(*head, repulsion=rad["trs"],
                                    compact_cols=True)
    assert full.shape == (810, 112) and comp.shape == (810, 32)
    assert torch.equal(full[:, 0:16], comp[:, 0:16])
    assert torch.equal(full[:, 48:64], comp[:, 16:32])
    assert torch.equal(e_f, e_c)
    rest = torch.ones(112, dtype=torch.bool)
    rest[0:16] = rest[48:64] = False
    assert not full[:, rest].any()
    carbon = torch.tensor(rad["third"] == 1)
    assert carbon.sum() == 60 and (full[carbon].abs().sum(1) > 0).all()
    # a carbon center has no section, hence no repulsion parameters
    assert not e_f[carbon].any() and (e_f[~carbon] > 0).all()


def test_radial_full_layout_matches_generic_oracle(rad):
    """Against `compute_aev` over a brute neighbor matrix, which never saw
    `sections`: the radial block of the generic AEV, 1e-10."""
    _, t, _, ta = rad["sys"]["water", torch.float64]
    species = torch.tensor(rad["species"])
    pos, box = t["pos"], t["box"]
    ghosts = tnb.build_ghosts(pos, box, 5.1, 8192, tnb.image_shifts(1))
    nl = tnb.build_neighbor_matrix_brute(pos, box, 5.1, 128, ghosts)
    diff, dist = tnb.neighbor_displacements(pos, box, nl)
    sj = tnb.extended_species(species, ghosts)[nl.idx]
    ref = taev.compute_aev(rad["tspec"], species, diff, dist, sj,
                           nl.mask & (sj >= 0), angular_capacity=48)[:, :112]
    got = rad["got"]["full"][0]
    assert ref.abs().max() > 0.1
    np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-10)


def test_radial_staleness_tolerates_skin_motion(rad):
    """Atoms moved by up to 0.9 A (below half the 2 A skin) without a
    rebuild: the frozen bins and assignment still hold every pair within
    Rcr, and the result is that of a fresh rebuild at the new positions."""
    _, t, _, ta = rad["sys"]["water", torch.float64]
    rng = np.random.default_rng(9)
    step = rng.standard_normal(rad["pos"].shape)
    step *= (0.9 * rng.random((len(step), 1)) ** (1 / 3)
             / np.linalg.norm(step, axis=1, keepdims=True))
    moved = t["pos"] + torch.tensor(step)
    stale = _port(rad, t, ta, "full", pos=moved)
    _, t2 = grids(rad["species"], moved.numpy(), rad["h"], rad["origin"])
    ta2 = tasn.build_assignment(t2["grid"], t2["bins"], t2["pos"], t2["box"],
                                rad["sections"], rad["kpad"], KEEP_R)
    assert float(ta2.ovf) <= 0
    fresh = _port(rad, t2, ta2, "full")
    assert (stale[0] - torch.tensor(rad["got"]["full"][0])).abs().max() > 0.1
    for a, b in zip(stale, fresh):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-12 * float(b.abs().max()))


# --- the plain versions behind the entry point ------------------------------


@pytest.fixture(scope="module")
def lanes(rad):
    """The radial backward's lane-level tensors for a seeded cotangent in
    each column layout."""
    _, t, _, ta = rad["sys"]["water", torch.float64]
    bins = t["bins"]
    pos_g, sp_g = tar._grid_inputs(bins.inv, t["pos"], bins.species_grid)
    rng = np.random.default_rng(21)
    nc, cap = sp_g.shape
    ga = torch.tensor(rng.standard_normal((nc, cap, 33)))
    ga_full = torch.zeros((nc, cap, 113), dtype=torch.float64)
    ga_full[..., 0:16] = ga[..., 0:16]
    ga_full[..., 48:64] = ga[..., 16:32]
    ga_full[..., 112] = ga[..., 32]
    ga_full[..., 16:48] = torch.tensor(rng.standard_normal((nc, cap, 32)))
    a = (pos_g, sp_g, t["box"].h, ta.idx)
    z = (t["grid"].ncells, rad["tspec"], rad["sections"], rad["trs"])
    return dict(
        ta=ta, sp_g=sp_g,
        gamma=tasn.radial_gamma_plain(*a, ga, *z),
        compact=tasn.radial_bwd_asn_plain(*a, ga, *z, compact_cols=True),
        full=tasn.radial_bwd_asn_plain(*a, ga_full, *z, compact_cols=False),
        rad_c=tasn.radial_fwd_asn_plain(*a, *z, compact_cols=True),
        rad_f=tasn.radial_fwd_asn_plain(*a, *z, compact_cols=False),
        step=tasn.step_fused_plain(*a, t["grid"].ncells, rad["tspec"],
                                   rad["sections"], rad["caps"], rad["trs"]))


def test_radial_fwd_asn_plain_is_the_radial_half_of_the_step(lanes):
    assert torch.equal(lanes["rad_c"], lanes["step"][0])
    f = lanes["rad_f"]
    assert f.shape[-1] == 113
    assert torch.equal(torch.cat([f[..., 0:16], f[..., 48:64], f[..., 112:]],
                                 -1), lanes["rad_c"])
    assert not f[..., 16:48].any() and not f[..., 64:112].any()


@pytest.mark.parametrize("layout", ["compact", "full"])
def test_radial_bwd_asn_plain_is_gamma_with_its_lane_sums(lanes, layout):
    """Its g equals radial_gamma_plain's (the full layout reads the same
    cotangents from other columns and ignores those of absent species), its
    fcen is g's lane sum, and dh carries the wrap shifts of live lanes
    only."""
    g, fcen, dh = lanes[layout]
    assert torch.equal(g, lanes["gamma"])
    np.testing.assert_allclose(fcen.numpy(), g.sum(-1).numpy(), rtol=0,
                               atol=1e-12 * float(fcen.abs().max()))
    assert dh.shape == (3, 3) and dh.abs().max() > 0


def test_radial_dead_lanes_and_empty_rows_give_exact_zeros(lanes):
    ta = lanes["ta"]
    g, fcen, _ = lanes["compact"]
    dead = (ta.idx >= ta.inv.shape[-1])[:, :, None, :].expand_as(g)
    assert dead.any() and not dead.all()
    assert not g[dead].any() and g[~dead].abs().max() > 0
    empty = lanes["sp_g"] < 0
    assert empty.any() and not fcen[empty].any()
    assert not lanes["rad_c"][empty].any()


def test_rows_beyond_n_out_carry_no_cotangent(rad):
    """With n_out the missing rows add nothing, yet every binned atom still
    takes its neighbor-role force: the gradient equals that of the full
    call with zero cotangents on the rows beyond n_out."""
    _, t, _, ta = rad["sys"]["water", torch.float64]
    cots = rad["cots"]["compact_nout"]
    got = _port_grads(rad, t, ta, "compact_nout", cots, plain=False)
    n = len(rad["species"])
    padded = [np.concatenate([c, np.zeros((n - N_OUT,) + c.shape[1:])])
              for c in cots]
    pos = t["pos"].clone().requires_grad_(True)
    h = t["box"].h.clone().requires_grad_(True)
    out = tasn.radial_aev_asn(
        rad["tspec"], t["grid"], t["bins"], ta, pos,
        Box(h=h, origin=t["box"].origin), rad["sections"],
        repulsion=rad["trs"], compact_cols=True)
    e = sum((o * torch.tensor(c)).sum() for o, c in zip(out, padded))
    ref = torch.autograd.grad(e, (pos, h))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.numpy())
    assert (np.abs(got[0][N_OUT:]).sum(1) > 0).sum() > 100


def test_radial_wrappers_count_plain_calls_on_the_cpu(rad):
    """On CPU tensors the per-channel wrappers run their plain versions
    and count them; nothing is launched and no fused kernel is touched."""
    _, t, _, ta = rad["sys"]["water", torch.float64]
    tasn.reset_counts()
    _port_grads(rad, t, ta, "full", rad["cots"]["full"], plain=False)
    want = dict.fromkeys(tasn.LAUNCHES, 0)
    want.update(radial_fwd_asn=1, radial_bwd_asn=1, wing=1)
    assert tasn.PLAIN_CALLS == want
    assert not any(tasn.LAUNCHES.values())
    assert set(tasn.REPLACES) == set(tasn.LAUNCHES)
    with pytest.raises(ValueError, match="n_out"):
        tasn.radial_aev_asn(rad["tspec"], t["grid"], t["bins"], ta, t["pos"],
                            t["box"], rad["sections"], n_out=811)
