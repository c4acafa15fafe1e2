"""The port's per-block angular pair stage (`pair_stage` "blocks" and
"blocks_full": block_fwd, block_bwd, block_fwd_tri and block_bwd_tri
through their plain versions, and the glue that runs one call per block
and tier) vs the JAX package's per-block stage (LAT_ANG_PACKED=0, with
LAT_ANG_TRI=1 and 0) in interpret mode, vs the port's packed stage (the
same function in another summation order) and vs autograd.

System and sizing as test_torch_asn_build.py (810 atoms, 3x3x3 coarse
bins, H and O sections, caps H 16 / O 16, f64); the port builds the
assignment and hands the same tables to the JAX side. The JAX switches
are read from the environment at every call, so each JAX call runs inside
a `pytest.MonkeyPatch.context()` that sets them and restores them after.
The JAX per-block stage in interpret mode takes tens of seconds per
forward and `jax.vjp`, so four entry-point references are computed once
per module; the other cases are held against the port's packed stage,
which the other test files hold against JAX.

Entry-point cases (angular_aev_asn), name: (stage, tiers, compact_cols,
n_out, dtype), "two" = tier 0 at caps (12, 8) for half the rows, then
the full caps:

  blocks_full_layout  blocks, untiered, full torchani layout   JAX + vjp
  blocks_two_nout     blocks, two tiers, compact, n_out 500    packed
  blocks_f32          blocks, two tiers, full layout, f32      JAX fwd
  full_full_layout    blocks_full, untiered, full layout       packed
  full_two_nout       blocks_full, two tiers, compact, n_out   JAX + vjp
  full_f32            blocks_full, two tiers, full layout, f32 packed

and aev_asn_fused with "blocks" and the XTB repulsion term (JAX + vjp).

Tolerances: forward f64 |err| <= 1e-10 + 1e-10 max|ref| against JAX, f32
atol 5e-6 rtol 1e-5; deficits exactly; (dpos, dh) against `jax.vjp` 1e-11
of the largest entry, against autograd through `plain=True` 1e-12 (f32
2e-6); against the packed stage 1e-12 of the largest entry (f32 2e-6).
The plain kernels against the JAX kernels on 64 of the fixture's flat
rows, at the full caps and at tier caps (12, 8): forward 1e-10 + 1e-10
max|ref|, slot sums 1e-12 of the largest entry.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ani_tpu.md import simulation as jsim
from lammps_ani_tpu.models import aev as jaev
from lammps_ani_tpu.models import repulsion as jrep
from lammps_ani_tpu.ops import aev_asn as jasn
from lammps_ani_tpu.ops import neighbors as jnb
from lammps_ani_torch import NeighborConfig, Simulation
from lammps_ani_torch.io.lammps_data import LammpsData, replicate
from lammps_ani_torch.models import aev as taev
from lammps_ani_torch.models import repulsion as trep
from lammps_ani_torch.models import zoo
from lammps_ani_torch.ops import aev_asn as tasn
from lammps_ani_torch.ops.neighbors import Box

from .fixtures import MASSES, WATER30_POS, WATER30_SPECIES
from .test_torch_asn_build import KEEP_R, asn_system, grids, sizing

SYMBOLS = ("H", "C", "N", "O", "S", "F", "Cl")
STAGES = ("blocks", "blocks_full")
SWITCH = {"blocks": "1", "blocks_full": "0"}  # LAT_ANG_TRI
N_OUT = 500
ROWS = 64  # flat rows of the kernel-level comparisons
CASES = {
    "blocks_full_layout": ("blocks", None, False, None, torch.float64),
    "blocks_two_nout": ("blocks", "two", True, N_OUT, torch.float64),
    "blocks_f32": ("blocks", "two", False, None, torch.float32),
    "full_full_layout": ("blocks_full", None, False, None, torch.float64),
    "full_two_nout": ("blocks_full", "two", True, N_OUT, torch.float64),
    "full_f32": ("blocks_full", "two", False, None, torch.float32),
}
JAX_CASES = ("blocks_full_layout", "blocks_f32", "full_two_nout")
VJP_CASES = ("blocks_full_layout", "full_two_nout")


@contextlib.contextmanager
def _switched(stage):
    """Selects the JAX per-block stage, and restores the environment."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("LAT_ANG_PACKED", "0")
        m.setenv("LAT_ANG_TRI", SWITCH[stage])
        yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(s, case, pos=None, box=None, plain=False, stage=None):
    st, tiers, compact, n_out, dtype = CASES[case]
    _, t = s["sys"][dtype]
    return tasn.angular_aev_asn(
        s["tspec"], t["grid"], t["bins"], s["ta"],
        t["pos"] if pos is None else pos, t["box"] if box is None else box,
        s["sections"], s["caps"], tiers=s["tiers"][tiers], n_out=n_out,
        compact_cols=compact, plain=plain, pair_stage=stage or st)


def _grads(fn, t, cot):
    """(dpos, dh) of sum(fn(pos, box) x cot) by autograd."""
    pos = t["pos"].clone().requires_grad_(True)
    h = t["box"].h.clone().requires_grad_(True)
    out = fn(pos, Box(h=h, origin=t["box"].origin))
    e = sum((o * torch.tensor(c, dtype=o.dtype)).sum()
            for o, c in zip(out, cot))
    return [g.numpy() for g in torch.autograd.grad(e, (pos, h))]


def _port_grads(s, case, cot, plain=False, stage=None):
    _, t = s["sys"][CASES[case][4]]
    return _grads(lambda p, b: _port(s, case, p, b, plain, stage)[:1], t,
                  [cot])


@pytest.fixture(scope="module")
def blk():
    species, pos, h, origin = asn_system()
    sections, kpad, caps, cnt = sizing(species, pos, h)
    n = len(species)
    j, t = grids(species, pos, h, origin)
    j32, t32 = grids(species, pos, h, origin, torch.float32)
    ta = tasn.build_assignment(t["grid"], t["bins"], t["pos"], t["box"],
                               sections, kpad, KEEP_R)
    ja = jasn.Assignment(idx=jnp.asarray(ta.idx.numpy()),
                         inv=jnp.asarray(ta.inv.numpy()),
                         ovf=jnp.asarray(float(ta.ovf)),
                         ovf_sec=jnp.asarray(ta.ovf_sec.numpy()))
    caps0 = tuple(max(4, c - 4) if s_ == 0 else (max(4, c - 8) if c else 0)
                  for s_, c in enumerate(caps))
    s = dict(species=species, pos=pos, sections=sections, kpad=kpad,
             caps=caps, caps0=caps0, cnt=cnt, ta=ta, ja=ja,
             jspec=jaev.ani2x_aev_spec(), tspec=taev.ani2x_aev_spec(),
             jrs=jrep.RepulsionSpec.for_symbols(SYMBOLS, cutoff=5.1),
             trs=trep.RepulsionSpec.for_symbols(SYMBOLS, cutoff=5.1),
             tiers={None: None, "two": ((caps0, n // 2), (caps, n))},
             sys={torch.float64: (j, t), torch.float32: (j32, t32)})

    ref, vjp_ref, cots = {}, {}, {}
    rng = np.random.default_rng(29)
    for case in JAX_CASES:
        stage, tr, compact, n_out, dtype = CASES[case]
        jj = s["sys"][dtype][0]

        def f(p, hh, jj=jj, tr=tr, compact=compact, n_out=n_out):
            return jasn.angular_aev_asn(
                s["jspec"], jj["grid"], jj["bins"], ja, p,
                jnb.Box(h=hh, origin=jj["box"].origin), sections, caps,
                tiers=s["tiers"][tr], interpret=True, n_out=n_out,
                compact_cols=compact)

        with _switched(stage):
            if case in VJP_CASES:
                out, vjp = jax.vjp(f, jj["pos"], jj["box"].h)
                cots[case] = rng.standard_normal(out[0].shape)
                vjp_ref[case] = [np.asarray(x) for x in vjp(
                    (jnp.asarray(cots[case]), jnp.zeros_like(out[1])))]
            else:
                out = f(jj["pos"], jj["box"].h)
        ref[case] = [np.asarray(o) for o in out]

    def fused(p, hh):
        out = jasn.aev_asn_fused(
            s["jspec"], j["grid"], j["bins"], ja, p,
            jnb.Box(h=hh, origin=j["box"].origin), sections, caps,
            repulsion=s["jrs"], interpret=True)
        return out[:3], out[3]

    with _switched("blocks"):
        out, vjp, deficit = jax.vjp(fused, j["pos"], j["box"].h,
                                    has_aux=True)
        cots["fused"] = [rng.standard_normal(o.shape) for o in out]
        vjp_ref["fused"] = [np.asarray(x) for x in vjp(
            tuple(jnp.asarray(c) for c in cots["fused"]))]
    ref["fused"] = [np.asarray(o) for o in (*out, deficit)]
    s.update(ref=ref, vjp_ref=vjp_ref, cots=cots,
             got={case: [o.numpy() for o in _port(s, case)]
                  for case in CASES})
    return s


# --- the entry points against JAX ------------------------------------------


@pytest.mark.parametrize("quantity", [0, 1], ids=["angular", "deficit"])
@pytest.mark.parametrize("case", JAX_CASES)
def test_angular_forward_matches_jax(blk, case, quantity):
    r, g = blk["ref"][case][quantity], blk["got"][case][quantity]
    _, tiers, compact, n_out, dtype = CASES[case]
    assert g.shape == r.shape
    if quantity == 1:
        assert g.shape == (8 if tiers else 7,)
        np.testing.assert_array_equal(g, r)
        assert g.max() <= 0
        return
    assert g.shape == (n_out or 810, 96 if compact else 896)
    assert np.abs(r).max() > 0
    if dtype == torch.float32:
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, r, atol=5e-6, rtol=1e-5)
    else:
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-10 + 1e-10 * np.abs(r).max())


@pytest.mark.parametrize("which", [0, 1], ids=["dpos", "dh"])
@pytest.mark.parametrize("case", VJP_CASES)
def test_angular_backward_matches_jax_vjp(blk, case, which):
    """(dpos, dh) of the explicit backward (the per-block backwards,
    decompact_chain, wing, the fold) vs `jax.vjp` of the JAX function
    under the same switches: 1e-11 of the largest entry."""
    g = _port_grads(blk, case, blk["cots"][case])[which]
    r = blk["vjp_ref"][case][which]
    assert g.shape == r.shape and np.abs(r).max() > 1.0
    np.testing.assert_allclose(g, r, rtol=0, atol=1e-11 * np.abs(r).max())


@pytest.mark.parametrize("quantity", range(4),
                         ids=["radial", "erep", "angular", "deficit"])
def test_fused_forward_matches_jax(blk, quantity):
    """`aev_asn_fused` with pair_stage "blocks" vs the JAX fused op under
    LAT_ANG_PACKED=0."""
    _, t = blk["sys"][torch.float64]
    got = tasn.aev_asn_fused(
        blk["tspec"], t["grid"], t["bins"], blk["ta"], t["pos"], t["box"],
        blk["sections"], blk["caps"], repulsion=blk["trs"],
        pair_stage="blocks")[quantity].numpy()
    ref = blk["ref"]["fused"][quantity]
    if quantity == 3:
        np.testing.assert_array_equal(got, ref)
        return
    assert got.shape == ref.shape and np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-10 + 1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("which", [0, 1], ids=["dpos", "dh"])
def test_fused_backward_matches_jax_vjp(blk, which):
    _, t = blk["sys"][torch.float64]
    g = _grads(lambda p, b: tasn.aev_asn_fused(
        blk["tspec"], t["grid"], t["bins"], blk["ta"], p, b, blk["sections"],
        blk["caps"], repulsion=blk["trs"], pair_stage="blocks")[:3], t,
        blk["cots"]["fused"])[which]
    r = blk["vjp_ref"]["fused"][which]
    assert np.abs(r).max() > 1.0
    np.testing.assert_allclose(g, r, rtol=0, atol=1e-11 * np.abs(r).max())


# --- the entry points against the packed stage and autograd -----------------


def _tol(dtype):
    return 1e-12 if dtype == torch.float64 else 2e-6


@pytest.mark.parametrize("case", list(CASES))
def test_angular_forward_matches_packed(blk, case):
    """The per-block stage sums the same pair terms as the packed one, in
    another order: outputs within 1e-12 of the largest entry (f32 2e-6),
    deficits equal."""
    dtype = CASES[case][4]
    got = blk["got"][case]
    ref = [o.numpy() for o in _port(blk, case, stage="packed")]
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[0].shape == ref[0].shape and np.abs(ref[0]).max() > 0
    np.testing.assert_allclose(got[0], ref[0], rtol=0,
                               atol=_tol(dtype) * np.abs(ref[0]).max())


@pytest.mark.parametrize("which", [0, 1], ids=["dpos", "dh"])
@pytest.mark.parametrize("case", list(CASES))
def test_angular_backward_matches_packed_and_autograd(blk, case, which):
    """The explicit backward vs the packed stage's explicit backward and vs
    autograd through the plain forwards (`plain=True`), one seeded
    cotangent: 1e-12 of the largest entry (f32 2e-6)."""
    dtype = CASES[case][4]
    cot = np.random.default_rng(3).standard_normal(blk["got"][case][0].shape)
    g = _port_grads(blk, case, cot)[which]
    tol = _tol(dtype)
    for r in (_port_grads(blk, case, cot, stage="packed")[which],
              _port_grads(blk, case, cot, plain=True)[which]):
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * np.abs(r).max())


def test_fused_blocks_matches_fused_packed(blk):
    """aev_asn_fused two tiers: forward and (dpos, dh) of "blocks_full"
    against "packed" within 1e-12 of the largest entry."""
    _, t = blk["sys"][torch.float64]
    res = {}
    for stage in ("packed", "blocks_full"):
        def fn(p, b, stage=stage):
            return tasn.aev_asn_fused(
                blk["tspec"], t["grid"], t["bins"], blk["ta"], p, b,
                blk["sections"], blk["caps"], tiers=blk["tiers"]["two"],
                repulsion=blk["trs"], pair_stage=stage)[:3]
        out = [o.detach().numpy() for o in fn(t["pos"], t["box"])]
        cots = [np.random.default_rng(31).standard_normal(o.shape)
                for o in out]
        res[stage] = out + _grads(fn, t, cots)
    for g, r in zip(res["blocks_full"], res["packed"]):
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12 * np.abs(r).max())


# --- the four plain versions against the JAX kernels -------------------------


@pytest.fixture(scope="module")
def flat(blk):
    """The first ROWS flat rows of the fixture's untiered forward."""
    _, t = blk["sys"][torch.float64]
    bins = t["bins"]
    static = (blk["tspec"], tuple(t["grid"].ncells), blk["sections"],
              blk["caps"], None, True, "blocks")
    _, (_, _, part) = tasn._angular_forward(
        static, t["pos"], t["box"].h, bins.inv, bins.species_grid, bins.cell,
        bins.slot, blk["ta"].idx, tasn._KERNELS)
    cat = part["cats"][0][:ROWS].contiguous()
    ga = torch.tensor(np.random.default_rng(37).standard_normal((ROWS, 96)))
    return dict(cat=cat, ga=ga, refs={})


def _plain_stage(s, cat, ga, caps_t, stage):
    """(columns [rows, n_blocks 32], slot sums [rows, 5 atot]) of the four
    plain versions called one block at a time."""
    a_offs, _ = tasn._a_offsets(s["sections"], s["caps"])
    cols, acc = [], torch.zeros_like(cat)
    for i, (kind, args) in enumerate(tasn._stage_blocks(
            s["tspec"], caps_t, a_offs, stage)):
        g = ga[:, 32 * i:32 * (i + 1)]
        if kind == "tri":
            cols.append(tasn.block_fwd_tri_plain(cat, s["tspec"], *args))
            tasn.block_bwd_tri_plain(cat, g, s["tspec"], *args, acc)
        elif kind == "block":
            cols.append(tasn.block_fwd_plain(cat, s["tspec"], *args))
            tasn.block_bwd_plain(cat, g, s["tspec"], *args, acc)
        else:
            cols.append(cat.new_zeros((cat.shape[0], 32)))
    return torch.cat(cols, 1).numpy(), acc.numpy()


def _jax_stage(s, cat, ga, caps_t, stage):
    """The JAX per-block kernels (`_run_fwd_blocks`, `_run_bwd_blocks`)
    under LAT_ANG_PACKED=0 on the same rows."""
    a_offs, atot = tasn._a_offsets(s["sections"], s["caps"])
    rows = cat.shape[0]
    cfl = [jnp.asarray(cat[:, f * atot:(f + 1) * atot].numpy())
           for f in range(5)]
    with _switched(stage):
        pieces = jasn._run_fwd_blocks(s["jspec"], caps_t, a_offs, cfl, rows,
                                      rows, True, jnp.float64)
        chans = sorted(pieces)
        gsum = jasn._run_bwd_blocks(
            s["jspec"], caps_t, a_offs, atot, cfl, jnp.asarray(ga.numpy()),
            {ch0: 32 * i for i, ch0 in enumerate(chans)}, rows, rows, True,
            jnp.float64)
    return (np.concatenate([np.asarray(pieces[c]) for c in chans], 1),
            np.concatenate([np.asarray(x) for x in gsum], 1))


@pytest.mark.parametrize("part", ["forward", "slot_sums"])
@pytest.mark.parametrize("caps", ["full", "tier"])
@pytest.mark.parametrize("stage", STAGES)
def test_plain_kernels_match_jax_kernels(blk, flat, stage, caps, part):
    caps_t = blk["caps"] if caps == "full" else blk["caps0"]
    key = (stage, caps)
    if key not in flat["refs"]:
        flat["refs"][key] = _jax_stage(blk, flat["cat"], flat["ga"], caps_t,
                                       stage)
    got = _plain_stage(blk, flat["cat"], flat["ga"], caps_t, stage)
    i = 0 if part == "forward" else 1
    r, g = flat["refs"][key][i], got[i]
    assert g.shape == r.shape and np.abs(r).max() > 0
    atol = (1e-10 + 1e-10 * np.abs(r).max() if part == "forward"
            else 1e-12 * np.abs(r).max())
    np.testing.assert_allclose(g, r, rtol=0, atol=atol)


@pytest.mark.parametrize("stage", STAGES)
def test_block_without_a_pair_keeps_its_zero_columns(blk, flat, stage):
    """A same-species cap of 1 (O): the triangle has no pair and the full
    matrix only its diagonal, so the O-O block's 32 columns are zeros, and
    they are present, as in JAX (the packed layout drops such a block);
    its slots take no cotangent from it. "blocks" against the JAX kernels,
    "blocks_full" against "blocks" (one JAX reference is enough: the full
    form's zero block is its diagonal alone)."""
    caps_t = (blk["caps0"][0], 0, 0, 1, 0, 0, 0)
    got = _plain_stage(blk, flat["cat"], flat["ga"], caps_t, stage)
    if stage == "blocks":
        ref = _jax_stage(blk, flat["cat"], flat["ga"], caps_t, stage)
        tol = (1e-10 + 1e-10 * np.abs(ref[0]).max(),
               1e-12 * np.abs(ref[1]).max())
    else:
        ref = _plain_stage(blk, flat["cat"], flat["ga"], caps_t, "blocks")
        tol = (1e-12 * np.abs(ref[0]).max(), 1e-12 * np.abs(ref[1]).max())
    assert got[0].shape == ref[0].shape == (ROWS, 96)
    assert not got[0][:, 64:].any() and np.abs(got[0][:, :64]).max() > 0
    for g, r, atol in zip(got, ref, tol):
        np.testing.assert_allclose(g, r, rtol=0, atol=atol)
    # the entry point keeps the block's columns too
    _, t = blk["sys"][torch.float64]
    caps = (blk["caps"][0], 0, 0, 1, 0, 0, 0)
    out, _ = tasn.angular_aev_asn(
        blk["tspec"], t["grid"], t["bins"], blk["ta"], t["pos"], t["box"],
        blk["sections"], caps, compact_cols=True, pair_stage=stage)
    assert out.shape == (810, 96) and not out[:, 64:].any()
    assert len(tasn.present_channels(blk["tspec"], caps,
                                     blk["sections"])) == 3


# --- the tier model, the simulation's tiers, the counts ---------------------


def _count_matrices(s):
    rng = np.random.default_rng(7)
    out = [(s["cnt"], s["caps"])]
    for _ in range(2):
        cnt = np.zeros((600, 7), np.int64)
        cnt[:, 0] = rng.integers(4, 21, 600)
        cnt[:, 1] = rng.integers(0, 9, 600)
        cnt[:, 3] = rng.integers(2, 13, 600)
        out.append((cnt, (24, 12, 0, 16, 0, 0, 0)))
        out.append((cnt, (20, 0, 0, 16, 0, 0, 0)))
    return out


@pytest.mark.parametrize("stage", STAGES)
def test_tier_search_matches_jax(blk, stage):
    """search_tiers under the per-block work model equals JAX's under the
    switch; the packed model (the default) is what it was."""
    found = 0
    for cnt, caps in _count_matrices(blk):
        with _switched(stage):
            ref = jasn.search_tiers(cnt, caps)
        assert tasn.search_tiers(cnt, caps, pair_stage=stage) == ref
        assert tasn.search_tiers(cnt, caps) == jasn.search_tiers(cnt, caps)
        found += ref is not None
    assert found >= 2


@pytest.mark.parametrize("stage", ("packed",) + STAGES)
def test_simulation_tiers_match_jax(blk, stage):
    """Simulation._derive_tiers: the ladder for the packed stage, two tiers
    under the per-block model otherwise, with the JAX engine's row
    margins (called on a stand-in for a 20,000-atom run)."""
    cnt = np.random.default_rng(5).integers(2, 19, (20000, 7))
    cnt[:, [1, 2, 4, 5, 6]] = 0
    caps = (20, 0, 0, 20, 0, 0, 0)
    got = Simulation._derive_tiers(
        types.SimpleNamespace(n_atoms=20000, pair_stage=stage), cnt, caps)
    with pytest.MonkeyPatch.context() as m:
        if stage != "packed":
            m.setenv("LAT_ANG_PACKED", "0")
            m.setenv("LAT_ANG_TRI", SWITCH[stage])
        ref = jsim.Simulation._derive_tiers(
            types.SimpleNamespace(n_atoms=20000), cnt, caps)
    assert got == ref and got is not None
    assert (len(got) == 2) == (stage != "packed")


def test_pair_stage_is_checked(blk):
    _, t = blk["sys"][torch.float64]
    with pytest.raises(ValueError, match="pair_stage"):
        tasn.angular_aev_asn(blk["tspec"], t["grid"], t["bins"], blk["ta"],
                             t["pos"], t["box"], blk["sections"],
                             blk["caps"], pair_stage="tri")
    with pytest.raises(ValueError, match="pair_stage"):
        tasn.search_tiers(blk["cnt"], blk["caps"], pair_stage="full")


@pytest.mark.parametrize("stage", STAGES)
def test_wrappers_count_plain_calls_on_the_cpu(blk, stage):
    """One call per block and tier (H-H, H-O, O-O; two tiers): triangles
    for the same-species blocks under "blocks", the full form otherwise;
    no packed call and no launch."""
    tasn.reset_counts()
    cot = np.random.default_rng(1).standard_normal((810, 896))
    _port_grads(blk, "blocks_f32" if stage == "blocks" else "full_f32",
                cot)
    tri = stage == "blocks"
    want = dict.fromkeys(tasn.LAUNCHES, 0)
    want.update(compact_asn=1, decompact_chain=1, wing=1,
                block_fwd=2 if tri else 6, block_bwd=2 if tri else 6,
                block_fwd_tri=4 if tri else 0,
                block_bwd_tri=4 if tri else 0)
    assert tasn.PLAIN_CALLS == want
    assert not any(tasn.LAUNCHES.values())
    assert set(tasn.REPLACES) == set(tasn.LAUNCHES)


def test_simulation_blocks_matches_packed():
    """Simulation(pair_stage="blocks"), 4 NVE steps of ANI-2x + XTB
    repulsion at 810 atoms (f64, CPU): positions within 1e-10 A and pe
    within rtol 1e-11 of the packed run."""
    tile = LammpsData(species=WATER30_SPECIES, positions=WATER30_POS,
                      masses_by_type=MASSES,
                      box_bounds=np.array([[-4.0, 4.0]] * 3), tilt=np.zeros(3))
    data = replicate(tile, 3, 3, 3)
    pot = zoo.ani2x(num_models=1, device="cpu", repulsion=True)
    res = {}
    for stage in ("packed", "blocks"):
        sim = Simulation(
            potential=pot, species=data.species,
            masses=data.masses_by_type[data.species],
            nbr=NeighborConfig(cutoff=5.1, skin=2.0, k_max=128,
                               ghost_capacity=4096, rebuild_every=2),
            dt=0.05, dtype=torch.float64, device="cpu", pair_stage=stage,
            engine="pallas_asn")
        box = Box(h=torch.tensor(data.box_h), origin=torch.tensor(
            data.box_origin))
        state = sim.init_state(data.positions, box, temp=300.0, seed=1)
        state, rows = sim.run(state, 4, thermo_every=1)
        assert sim.pair_stage == stage and sim._tiers is None
        res[stage] = (sim.positions_input_order(state),
                      [r["pe"] for r in rows])
    np.testing.assert_allclose(res["blocks"][0], res["packed"][0], rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(res["blocks"][1], res["packed"][1],
                               rtol=1e-11)
