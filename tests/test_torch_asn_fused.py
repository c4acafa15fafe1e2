"""The port's fused asn forward (`aev_asn_fused`: the step kernel's
radial + XTB + stage-2 compaction and the packed angular pairs, through
their plain versions) vs the JAX package's `aev_asn_fused` in interpret
mode.

System and sizing as test_torch_asn_build.py (810 atoms, 3x3x3 coarse
bins); one assignment, built by the JAX package, serves both sides (the
build test holds the port's tables equal to it). Cases: ANI-2x with the
XTB repulsion term; without it; occupancy tiers passed explicitly (tier
0 at caps - 4, the last at the full caps); a last tier too small for
the rows (spill); f32. The JAX outputs are computed once per module.

Tolerances: f64 |err| <= 1e-10 + 1e-10 * max|ref| (the stage-2 slot
fields 1e-12); f32 atol 5e-6 rtol 1e-5 (as tests/test_aev_pallas.py).
Integer outputs (deficits, rank2) must be equal.
"""

import numpy as np
import pytest
import torch

from lammps_ani_tpu.models import aev as jaev
from lammps_ani_tpu.models import repulsion as jrep
from lammps_ani_tpu.ops import aev_asn as jasn
from lammps_ani_torch.models import aev as taev
from lammps_ani_torch.models import repulsion as trep
from lammps_ani_torch.ops import aev_asn as tasn
from lammps_ani_torch.ops import aev_roll as tar

from .test_torch_asn_build import KEEP_R, asn_system, grids, sizing

SYMBOLS = ("H", "C", "N", "O", "S", "F", "Cl")
QUANTITIES = ("radial", "erep", "angular", "deficit")
CASES = ("rep", "norep", "tiered", "f32")

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: with several test processes on one machine, each
    with a thread per core, the threads wait on one another at every
    operation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _as_np(out):
    return {q: np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                          else x) for q, x in zip(QUANTITIES, out)}


@pytest.fixture(scope="module")
def fused():
    species, pos, h, origin = asn_system()
    sections, kpad, caps, _ = sizing(species, pos, h)
    j, t = grids(species, pos, h, origin)
    ja = jasn.build_assignment(j["grid"], j["bins"], j["pos"], j["box"],
                               sections, kpad, KEEP_R, interpret=True)
    ta = tasn.Assignment(idx=torch.tensor(np.asarray(ja.idx)),
                         inv=torch.tensor(np.asarray(ja.inv)),
                         ovf=torch.tensor(float(ja.ovf)),
                         ovf_sec=torch.tensor(np.asarray(ja.ovf_sec)))
    jspec, tspec = jaev.ani2x_aev_spec(), taev.ani2x_aev_spec()
    jrs = jrep.RepulsionSpec.for_symbols(SYMBOLS, cutoff=5.1)
    trs = trep.RepulsionSpec.for_symbols(SYMBOLS, cutoff=5.1)
    n = len(species)
    caps0 = tuple(max(4, c - 4) if c else 0 for c in caps)
    tiers = {"tiered": ((caps0, n // 2), (caps, n)),
             "spill": (((4, 0, 0, 4, 0, 0, 0), 8), (caps, 8))}

    def run_jax(j, rep, tr=None):
        return _as_np(jasn.aev_asn_fused(
            jspec, j["grid"], j["bins"], ja, j["pos"], j["box"], sections,
            caps, tiers=tr, repulsion=rep, interpret=True))

    def run_port(t, rep, tr=None):
        return _as_np(tasn.aev_asn_fused(
            tspec, t["grid"], t["bins"], ta, t["pos"], t["box"], sections,
            caps, tiers=tr, repulsion=rep))

    ref, got = {}, {}
    # the rep case through the JAX impl, which also returns the stage-2
    # slots and rank2
    out, (compact, rank2, _) = jasn._both_asn_impl(
        jspec, j["grid"], sections, kpad, caps, None, jrs, True, None,
        j["pos"], j["box"].h, j["bins"].inv, j["bins"].species_grid,
        j["bins"].cell, j["bins"].slot, ja.idx, want_res=True)
    ref["rep"], got["rep"] = _as_np(out), run_port(t, trs)
    ref["norep"], got["norep"] = run_jax(j, None), run_port(t, None)
    for case in ("tiered", "spill"):
        ref[case] = run_jax(j, jrs, tiers[case])
        got[case] = run_port(t, trs, tiers[case])
    j32, t32 = grids(species, pos, h, origin, torch.float32)
    ref["f32"], got["f32"] = run_jax(j32, jrs), run_port(t32, trs)

    nc = t["grid"].total
    pos_g, sp_g = tar._grid_inputs(t["bins"].inv, t["pos"],
                                   t["bins"].species_grid)
    _, cmp, r2, _ = tasn.step_fused_plain(
        pos_g, sp_g, t["box"].h, ta.idx, t["grid"].ncells, tspec, sections,
        caps, trs)
    stage2 = dict(ref_rank2=np.asarray(rank2)[:nc], rank2=r2.numpy(),
                  ref_cmp=[np.asarray(c)[:nc] for c in compact],
                  cmp=cmp.numpy())
    return ref, got, stage2, tiers


@pytest.mark.parametrize("quantity", QUANTITIES)
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(fused, case, quantity):
    ref, got, _, _ = fused
    r, g = ref[case][quantity], got[case][quantity]
    assert g.shape == r.shape
    if quantity == "deficit":
        np.testing.assert_array_equal(g, r)
        assert r[:7].max() <= 0 and r.max() <= 0
        return
    if quantity == "erep" and case == "norep":
        assert not g.any() and not r.any()
        return
    assert np.abs(r).max() > 0
    if case == "f32":
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, r, atol=5e-6, rtol=1e-5)
    else:
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-10 + 1e-10 * np.abs(r).max())


def test_spill_deficit_matches_jax(fused):
    """A last tier too small for its rows reports the spilled rows in the
    deficit's trailing entry, as in JAX; the per-species caps did not
    truncate."""
    ref, got, _, _ = fused
    r, g = ref["spill"]["deficit"], got["spill"]["deficit"]
    np.testing.assert_array_equal(g, r)
    assert g[-1] > 0 and g[:-1].max() <= 0


def test_tiers_are_exact(fused):
    """Tiered rows lose only dead slots: the tiered angular AEV equals
    the untiered one, and the deficit gains one entry (no spill)."""
    _, got, _, _ = fused
    np.testing.assert_allclose(got["tiered"]["angular"],
                               got["rep"]["angular"], atol=1e-12, rtol=0)
    np.testing.assert_array_equal(got["tiered"]["deficit"][:-1],
                                  got["rep"]["deficit"])
    assert got["tiered"]["deficit"][-1] <= 0


def test_stage2_slots_match_jax(fused):
    """The step's stage-2 output: rank2 equal, the six packed slot fields
    (ux, uy, uz, d, fc, dfc) to 1e-12."""
    _, _, s, _ = fused
    np.testing.assert_array_equal(s["rank2"], s["ref_rank2"])
    for f, ref in enumerate(s["ref_cmp"]):
        np.testing.assert_allclose(s["cmp"][:, :, f], ref, atol=1e-12,
                                   rtol=0)


def test_repulsion_column_is_positive_and_apart(fused):
    """With the term on, every atom gets a positive repulsion energy
    (each water atom has a neighbor inside 5.1 A), and the radial columns
    are those computed without it."""
    _, got, _, _ = fused
    assert (got["rep"]["erep"] > 0).all()
    np.testing.assert_array_equal(got["rep"]["radial"],
                                  got["norep"]["radial"])


# --- n_out: rows of the first atoms only ------------------------------------

N_OUT = 500


@pytest.fixture(scope="module")
def fused_nout():
    """`aev_asn_fused(n_out=500)` of 810 atoms, tiered, with repulsion:
    outputs and the `jax.vjp` of seeded normal cotangents on (radial, erep,
    angular), once, beside the port's outputs and explicit backward."""
    import jax
    import jax.numpy as jnp

    from lammps_ani_tpu.ops import neighbors as jnb
    from lammps_ani_torch.ops.neighbors import Box

    species, pos, h, origin = asn_system()
    sections, kpad, caps, _ = sizing(species, pos, h)
    j, t = grids(species, pos, h, origin)
    ta = tasn.build_assignment(t["grid"], t["bins"], t["pos"], t["box"],
                               sections, kpad, KEEP_R)
    ja = jasn.Assignment(idx=jnp.asarray(ta.idx.numpy()),
                         inv=jnp.asarray(ta.inv.numpy()),
                         ovf=jnp.asarray(float(ta.ovf)),
                         ovf_sec=jnp.asarray(ta.ovf_sec.numpy()))
    jspec, tspec = jaev.ani2x_aev_spec(), taev.ani2x_aev_spec()
    jrs = jrep.RepulsionSpec.for_symbols(SYMBOLS, cutoff=5.1)
    trs = trep.RepulsionSpec.for_symbols(SYMBOLS, cutoff=5.1)
    caps0 = tuple(max(4, c - 4) if c else 0 for c in caps)
    tiers = ((caps0, N_OUT // 2), (caps, N_OUT))

    def f(p, hh):
        return jasn.aev_asn_fused(
            jspec, j["grid"], j["bins"], ja, p,
            jnb.Box(h=hh, origin=j["box"].origin), sections, caps,
            tiers=tiers, repulsion=jrs, interpret=True, n_out=N_OUT)

    out, vjp = jax.vjp(f, j["pos"], j["box"].h)
    rng = np.random.default_rng(19)
    cots = [rng.standard_normal(o.shape) for o in out[:3]]
    ref_grads = vjp(tuple(jnp.asarray(c) for c in cots)
                    + (jnp.zeros_like(out[3]),))

    p = t["pos"].clone().requires_grad_(True)
    hh = t["box"].h.clone().requires_grad_(True)
    got = tasn.aev_asn_fused(tspec, t["grid"], t["bins"], ta, p,
                             Box(h=hh, origin=t["box"].origin), sections,
                             caps, tiers=tiers, repulsion=trs, n_out=N_OUT)
    e = sum((o * torch.tensor(c)).sum() for o, c in zip(got[:3], cots))
    got_grads = torch.autograd.grad(e, (p, hh))
    return dict(ref=_as_np(out), got=_as_np(got),
                ref_grads=[np.asarray(g) for g in ref_grads],
                got_grads=[g.numpy() for g in got_grads])


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_forward_with_n_out_matches_jax(fused_nout, quantity):
    """Rows of the first n_out binned atoms only, the pair stage and the
    tier partition over those rows; f64 limits as above."""
    r, g = fused_nout["ref"][quantity], fused_nout["got"][quantity]
    assert g.shape == r.shape
    if quantity == "deficit":
        np.testing.assert_array_equal(g, r)
        assert g.shape == (8,) and g.max() <= 0
        return
    assert g.shape[0] == N_OUT and np.abs(r).max() > 0
    np.testing.assert_allclose(g, r, rtol=0,
                               atol=1e-10 + 1e-10 * np.abs(r).max())


@pytest.mark.parametrize("which", [0, 1], ids=["dpos", "dh"])
def test_backward_with_n_out_matches_jax_vjp(fused_nout, which):
    """The rows beyond n_out carry zero cotangent, while every binned atom
    takes its neighbor-role force: 1e-11 of the largest entry."""
    r, g = fused_nout["ref_grads"][which], fused_nout["got_grads"][which]
    assert g.shape == r.shape and np.abs(r).max() > 1.0
    np.testing.assert_allclose(g, r, rtol=0, atol=1e-11 * np.abs(r).max())
    if which == 0:
        assert (np.abs(g[N_OUT:]).sum(1) > 0).sum() > 100
