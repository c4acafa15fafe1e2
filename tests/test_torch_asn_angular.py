"""The port's per-channel angular surface (`angular_aev_asn`: compact_asn,
the packed pair stage, decompact_chain and wing through their plain
versions, and the glue between them) vs the JAX package's `angular_aev_asn`
in interpret mode, vs autograd, vs the fused op and vs the generic AEV
oracle.

System and sizing as test_torch_asn_build.py (810 atoms, 3x3x3 coarse bins,
H and O sections, f64); the port builds the assignment and hands the same
tables to the JAX side (tests/test_torch_asn_radial.py and
tests/test_torch_asn_build.py hold them equal to JAX's own). Cases (the JAX
outputs are computed once per module):

  full         untiered, full torchani layout (28 x 32 columns)
  tiered_nout  a three-tier ladder, compact columns (3 x 32), rows of the
               first 500 atoms only
  truncated    caps 8 below the sized ones: the deficit is > 0 and both
               sides keep the same first lanes
  spill        a last tier too small for its rows: the deficit's trailing
               entry is > 0 (the deficit alone is compared)
  f32          tiered, full layout, float32

Tolerances: forward f64 |err| <= 1e-10 + 1e-10 max|ref| (as the fused
forward's test), f32 atol 5e-6 rtol 1e-5; deficits exactly; (dpos, dh) vs
`jax.vjp` 1e-11 of the largest entry, vs autograd through the plain forwards
(`plain=True`) 1e-12 of the largest entry (f32: 2e-6); against
`aev_asn_fused` the forward is equal bit for bit, and d(radial) + d(angular)
equals the fused gradient to 1e-9 (dpos) and 1e-8 (dh).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ani_tpu.models import aev as jaev
from lammps_ani_tpu.ops import aev_asn as jasn
from lammps_ani_tpu.ops import neighbors as jnb
from lammps_ani_torch.models import aev as taev
from lammps_ani_torch.models import repulsion as trep
from lammps_ani_torch.ops import aev_asn as tasn
from lammps_ani_torch.ops import aev_roll as tar
from lammps_ani_torch.ops import neighbors as tnb
from lammps_ani_torch.ops.neighbors import Box

from .test_torch_asn_build import KEEP_R, asn_system, grids, sizing

SYMBOLS = ("H", "C", "N", "O", "S", "F", "Cl")
N_OUT = 500
# name: (caps, tiers, compact_cols, n_out, dtype); caps and tiers name
# entries of the fixture's tables
CASES = {"full": ("sized", None, False, None, torch.float64),
         "tiered_nout": ("sized", "ladder", True, N_OUT, torch.float64),
         "truncated": ("tight", None, True, None, torch.float64),
         "spill": ("sized", "spill", True, None, torch.float64),
         "f32": ("sized", "ladder", False, None, torch.float32)}
VJP_CASES = ("full", "tiered_nout")
GRAD_CASES = ("full", "tiered_nout", "truncated", "f32")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions are chains of small tensor operations; one
    thread keeps this file's time flat when several test processes share
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(s, t, case, pos=None, box=None, plain=False, ta=None):
    caps, tiers, compact, n_out, _ = CASES[case]
    return tasn.angular_aev_asn(
        s["tspec"], t["grid"], t["bins"], s["ta"] if ta is None else ta,
        t["pos"] if pos is None else pos, t["box"] if box is None else box,
        s["sections"], s["caps"][caps], tiers=s["tiers"][tiers],
        n_out=n_out, compact_cols=compact, plain=plain)


def _port_grads(s, t, case, cot, plain, dtype=torch.float64):
    pos = t["pos"].clone().requires_grad_(True)
    h = t["box"].h.clone().requires_grad_(True)
    out, _ = _port(s, t, case, pos, Box(h=h, origin=t["box"].origin), plain)
    e = (out * torch.tensor(cot, dtype=dtype)).sum()
    dpos, dh = torch.autograd.grad(e, (pos, h))
    return dpos.numpy(), dh.numpy()


@pytest.fixture(scope="module")
def ang():
    species, pos, h, origin = asn_system()
    sections, kpad, caps, _ = sizing(species, pos, h)
    n = len(species)
    j, t = grids(species, pos, h, origin)
    j32, t32 = grids(species, pos, h, origin, torch.float32)
    ta = tasn.build_assignment(t["grid"], t["bins"], t["pos"], t["box"],
                               sections, kpad, KEEP_R)
    ja = jasn.Assignment(idx=jnp.asarray(ta.idx.numpy()),
                         inv=jnp.asarray(ta.inv.numpy()),
                         ovf=jnp.asarray(float(ta.ovf)),
                         ovf_sec=jnp.asarray(ta.ovf_sec.numpy()))

    def less(k):
        return tuple(max(4, c - k) if c else 0 for c in caps)

    s = dict(species=species, pos=pos, h=h, origin=origin, sections=sections,
             kpad=kpad, ta=ta, jspec=jaev.ani2x_aev_spec(),
             tspec=taev.ani2x_aev_spec(),
             trs=trep.RepulsionSpec.for_symbols(SYMBOLS, cutoff=5.1),
             caps={"sized": caps, "tight": less(8)},
             tiers={None: None,
                    "ladder": ((less(8), n // 3), (less(4), n // 3),
                               (caps, n)),
                    "spill": (((4, 0, 0, 4, 0, 0, 0), 8), (caps, 8))},
             sys={torch.float64: (j, t), torch.float32: (j32, t32)})

    ref, got, vjp_ref, cots = {}, {}, {}, {}
    rng = np.random.default_rng(13)
    for case, (cp, tr, compact, n_out, dtype) in CASES.items():
        j, t = s["sys"][dtype]

        def f(p, hh, j=j, cp=cp, tr=tr, compact=compact, n_out=n_out):
            return jasn.angular_aev_asn(
                s["jspec"], j["grid"], j["bins"], ja, p,
                jnb.Box(h=hh, origin=j["box"].origin), sections,
                s["caps"][cp], tiers=s["tiers"][tr], interpret=True,
                n_out=n_out, compact_cols=compact)

        if case in VJP_CASES:
            out, vjp = jax.vjp(f, j["pos"], j["box"].h)
            cots[case] = rng.standard_normal(out[0].shape)
            vjp_ref[case] = [np.asarray(x) for x in vjp(
                (jnp.asarray(cots[case]), jnp.zeros_like(out[1])))]
        else:
            out = f(j["pos"], j["box"].h)
        ref[case] = [np.asarray(o) for o in out]
        got[case] = [o.numpy() for o in _port(s, t, case)]
    s.update(ref=ref, got=got, vjp_ref=vjp_ref, cots=cots)
    return s


@pytest.mark.parametrize("quantity", [0, 1], ids=["angular", "deficit"])
@pytest.mark.parametrize("case", list(CASES))
def test_angular_forward_matches_jax(ang, case, quantity):
    r, g = ang["ref"][case][quantity], ang["got"][case][quantity]
    _, tiers, compact, n_out, dtype = CASES[case]
    assert g.shape == r.shape
    if quantity == 1:
        # per species, and the rows the last tier could not hold if tiered
        assert g.shape == (8 if tiers else 7,)
        np.testing.assert_array_equal(g, r)
        assert (g[:7].max() > 0) == (case == "truncated")
        assert (tiers is not None and g[-1] > 0) == (case == "spill")
        return
    assert g.shape == (n_out or 810, 96 if compact else 896)
    if case == "spill":
        return  # spilled rows hold no result on either side
    assert np.abs(r).max() > 0
    if dtype == torch.float32:
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, r, atol=5e-6, rtol=1e-5)
    else:
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-10 + 1e-10 * np.abs(r).max())


@pytest.mark.parametrize("which", [0, 1], ids=["dpos", "dh"])
@pytest.mark.parametrize("case", VJP_CASES)
def test_angular_backward_matches_jax_vjp(ang, case, which):
    """(dpos, dh) for a seeded normal cotangent vs `jax.vjp` of the JAX
    function: 1e-11 of the largest entry."""
    _, t = ang["sys"][torch.float64]
    g = _port_grads(ang, t, case, ang["cots"][case], plain=False)[which]
    r = ang["vjp_ref"][case][which]
    assert g.shape == r.shape and np.abs(r).max() > 1.0
    np.testing.assert_allclose(g, r, rtol=0, atol=1e-11 * np.abs(r).max())


@pytest.mark.parametrize("which", [0, 1], ids=["dpos", "dh"])
@pytest.mark.parametrize("case", GRAD_CASES)
def test_angular_backward_matches_autograd_through_plain_forwards(ang, case,
                                                                  which):
    """The explicit backward (packed_bwd, decompact_chain, wing, fold) vs
    autograd through `plain=True`, which never touches it."""
    dtype = CASES[case][4]
    _, t = ang["sys"][dtype]
    cot = np.random.default_rng(3).standard_normal(ang["got"][case][0].shape)
    g = _port_grads(ang, t, case, cot, False, dtype)[which]
    r = _port_grads(ang, t, case, cot, True, dtype)[which]
    tol = 1e-12 if dtype == torch.float64 else 2e-6
    assert np.abs(r).max() > 0
    np.testing.assert_allclose(g, r, rtol=0, atol=tol * np.abs(r).max())


@pytest.mark.parametrize("tiering", [None, "ladder"],
                         ids=["untiered", "tiered"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_angular_forward_equals_fused_bit_for_bit(ang, dtype, tiering):
    """`angular_aev_asn(compact_cols=True)` runs the stage-2 half of the
    fused step on the same lanes in the same order, then the same pair
    stage: outputs and deficits are equal."""
    _, t = ang["sys"][dtype]
    head = (ang["tspec"], t["grid"], t["bins"], ang["ta"], t["pos"],
            t["box"], ang["sections"], ang["caps"]["sized"])
    for n_out in (None, N_OUT):
        fused = tasn.aev_asn_fused(*head, tiers=ang["tiers"][tiering],
                                   repulsion=ang["trs"], n_out=n_out)
        alone = tasn.angular_aev_asn(*head, tiers=ang["tiers"][tiering],
                                     n_out=n_out, compact_cols=True)
        assert torch.equal(alone[0], fused[2])
        assert torch.equal(alone[1], fused[3])


@pytest.mark.parametrize("which", [0, 1], ids=["dpos", "dh"])
def test_summed_channel_gradients_equal_the_fused_gradient(ang, which):
    """The fused backward sums the channels on the compact lanes before
    one wing gather and one fold; the channels each run their own. Same
    cotangents: dpos within 1e-9, dh within 1e-8 (f64)."""
    _, t = ang["sys"][torch.float64]
    head = (ang["tspec"], t["grid"], t["bins"], ang["ta"])
    tiers, caps = ang["tiers"]["ladder"], ang["caps"]["sized"]
    rng = np.random.default_rng(17)

    def grads(fn):
        pos = t["pos"].clone().requires_grad_(True)
        h = t["box"].h.clone().requires_grad_(True)
        e = fn(pos, Box(h=h, origin=t["box"].origin))
        return torch.autograd.grad(e, (pos, h))[which]

    c_rad, c_rep, c_ang = (torch.tensor(rng.standard_normal(sh))
                           for sh in ((810, 32), (810,), (810, 96)))

    def fused(pos, box):
        o = tasn.aev_asn_fused(*head, pos, box, ang["sections"], caps,
                               tiers=tiers, repulsion=ang["trs"])
        return (o[0] * c_rad).sum() + (o[1] * c_rep).sum() + (o[2]
                                                              * c_ang).sum()

    def radial(pos, box):
        o = tasn.radial_aev_asn(*head, pos, box, ang["sections"],
                                repulsion=ang["trs"], compact_cols=True)
        return (o[0] * c_rad).sum() + (o[1] * c_rep).sum()

    def angular(pos, box):
        o = tasn.angular_aev_asn(*head, pos, box, ang["sections"], caps,
                                 tiers=tiers, compact_cols=True)
        return (o[0] * c_ang).sum()

    ref = grads(fused)
    got = grads(radial) + grads(angular)
    assert ref.abs().max() > 1.0
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=(1e-9, 1e-8)[which])


def test_full_layout_places_the_present_blocks(ang):
    """Full layout: the H-H, H-O and O-O blocks sit at their torchani
    offsets (`present_channels`), the other 25 blocks are exactly zero."""
    full = torch.tensor(ang["got"]["full"][0])
    _, t = ang["sys"][torch.float64]
    comp, _ = tasn.angular_aev_asn(
        ang["tspec"], t["grid"], t["bins"], ang["ta"], t["pos"], t["box"],
        ang["sections"], ang["caps"]["sized"], compact_cols=True)
    chans = tasn.present_channels(ang["tspec"], ang["caps"]["sized"],
                                  ang["sections"])
    assert len(chans) == 3 and full.shape == (810, 896)
    rest = torch.ones(896, dtype=torch.bool)
    for i, ch0 in enumerate(chans):
        assert torch.equal(full[:, ch0:ch0 + 32], comp[:, 32 * i:32 * i + 32])
        rest[ch0:ch0 + 32] = False
    assert not full[:, rest].any() and comp.abs().max() > 0


def test_angular_full_layout_matches_generic_oracle(ang):
    """Against `compute_aev` over a brute neighbor matrix, which never saw
    `sections` or caps: the angular block of the generic AEV, 1e-10."""
    _, t = ang["sys"][torch.float64]
    species = torch.tensor(ang["species"])
    pos, box = t["pos"], t["box"]
    ghosts = tnb.build_ghosts(pos, box, 5.1, 8192, tnb.image_shifts(1))
    nl = tnb.build_neighbor_matrix_brute(pos, box, 5.1, 128, ghosts)
    diff, dist = tnb.neighbor_displacements(pos, box, nl)
    sj = tnb.extended_species(species, ghosts)[nl.idx]
    ref = taev.compute_aev(ang["tspec"], species, diff, dist, sj,
                           nl.mask & (sj >= 0), angular_capacity=48)[:, 112:]
    got = ang["got"]["full"][0]
    assert ref.abs().max() > 0.1
    np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-10)


def test_angular_staleness_tolerates_skin_motion(ang):
    """Atoms moved by up to 0.5 A (below half the 2 A skin) without a
    rebuild: stage 2 re-compacts the frozen lanes at the new positions, so
    the result is that of a fresh rebuild there. The caps get 8 slots of
    headroom for the disordered geometry (deficit <= 0 on both sides)."""
    _, t = ang["sys"][torch.float64]
    rng = np.random.default_rng(9)
    step = rng.standard_normal(ang["pos"].shape)
    step *= (0.5 * rng.random((len(step), 1)) ** (1 / 3)
             / np.linalg.norm(step, axis=1, keepdims=True))
    moved = t["pos"] + torch.tensor(step)
    caps = tuple(c + 8 if c else 0 for c in ang["caps"]["sized"])

    def run(t, ta, pos):
        return tasn.angular_aev_asn(ang["tspec"], t["grid"], t["bins"], ta,
                                    pos, t["box"], ang["sections"], caps,
                                    compact_cols=True)

    stale, d_stale = run(t, ang["ta"], moved)
    _, t2 = grids(ang["species"], moved.numpy(), ang["h"], ang["origin"])
    ta2 = tasn.build_assignment(t2["grid"], t2["bins"], t2["pos"], t2["box"],
                                ang["sections"], ang["kpad"], KEEP_R)
    fresh, d_fresh = run(t2, ta2, t2["pos"])
    assert float(ta2.ovf) <= 0 and d_stale.max() <= 0 and d_fresh.max() <= 0
    assert (stale - run(t, ang["ta"], t["pos"])[0]).abs().max() > 0.1
    np.testing.assert_allclose(stale.numpy(), fresh.numpy(), rtol=0,
                               atol=1e-12 * float(fresh.abs().max()))


# --- the plain versions behind the entry point ------------------------------


@pytest.fixture(scope="module")
def stages(ang):
    """Stage-2 outputs and the chain's tensors (tiered) for a seeded
    cotangent."""
    _, t = ang["sys"][torch.float64]
    ta, bins = ang["ta"], t["bins"]
    caps, tiers = ang["caps"]["sized"], ang["tiers"]["ladder"]
    pos_g, sp_g = tar._grid_inputs(bins.inv, t["pos"], bins.species_grid)
    a = (pos_g, sp_g, t["box"].h, ta.idx, t["grid"].ncells, ang["tspec"],
         ang["sections"])
    step = tasn.step_fused_plain(*a, caps, ang["trs"])
    alone = tasn.compact_asn_plain(*a, caps)
    static = (ang["tspec"], tuple(t["grid"].ncells), ang["sections"], caps,
              tiers, True, "packed")
    _, (cmp, rank2, part) = tasn._angular_forward(
        static, t["pos"], t["box"].h, bins.inv, bins.species_grid, bins.cell,
        bins.slot, ta.idx, tasn._KERNELS)
    g_ang = torch.tensor(np.random.default_rng(23).standard_normal((810, 96)))
    gsum = tasn._angular_gsum_grid(ang["tspec"], ang["sections"], caps, 810,
                                   bins.inv, g_ang, part, tasn._KERNELS)
    chain = (rank2, ta.idx, cmp, gsum)
    z = (t["grid"].ncells, ang["tspec"])
    return dict(step=step, alone=alone, cmp=cmp, rank2=rank2, gsum=gsum,
                sp_g=sp_g,
                dec=tasn.decompact_chain_plain(*chain, *z),
                summed=tasn.chain_sum_plain(
                    *chain, torch.zeros((*ta.idx.shape[:2], 3, ang["kpad"]),
                                        dtype=torch.float64), *z))


@pytest.mark.parametrize("which", [0, 1, 2], ids=["cmp", "rank2", "deficit"])
def test_compact_asn_plain_is_the_stage2_half_of_the_step(stages, which):
    """Slot fields, rank2 and deficit of `compact_asn_plain` equal those of
    `step_fused_plain`; the entry point's forward carries the same."""
    assert torch.equal(stages["alone"][which], stages["step"][1 + which])
    if which < 2:
        assert torch.equal((stages["cmp"], stages["rank2"])[which],
                           stages["alone"][which])


@pytest.mark.parametrize("which", [0, 1, 2], ids=["gt", "fcen", "dh"])
def test_decompact_chain_plain_is_chain_sum_without_a_radial_part(stages,
                                                                  which):
    got, ref = stages["dec"][which], stages["summed"][which]
    assert ref.abs().max() > 0
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_angular_dead_lanes_and_dead_slots_give_exact_zeros(ang, stages):
    """Lanes without a slot (rank2 127) get exactly 0 from the chain; dead
    slots hold u = 0, d = 2 Rca + 10, fc = dfc = 0; empty grid rows get no
    center force."""
    gt, fcen, _ = stages["dec"]
    no_slot = (stages["rank2"] == tasn.DEAD_SLOT)[:, :, None, :].expand_as(gt)
    assert no_slot.any() and not no_slot.all()
    assert not gt[no_slot].any() and gt[~no_slot].abs().max() > 0
    cmp = stages["cmp"]
    big = 2.0 * ang["tspec"].angular_cutoff + 10.0
    dead = cmp[:, :, 3] == big
    assert dead.any() and not dead.all()
    for f in (0, 1, 2, 4, 5):
        assert not cmp[:, :, f][dead].any()
    assert (cmp[:, :, 3][~dead] <= ang["tspec"].angular_cutoff).all()
    empty = stages["sp_g"] < 0
    assert empty.any() and not fcen[empty].any()


def test_rows_beyond_n_out_carry_no_cotangent(ang):
    """With n_out the pair stage runs on the first rows only, yet every
    binned atom still takes its neighbor-role force: the gradient is that
    of the full call with zero cotangents on the rows beyond n_out (the
    tier partition differs, so equal to rounding, not bit for bit)."""
    _, t = ang["sys"][torch.float64]
    cot = ang["cots"]["tiered_nout"]
    got = _port_grads(ang, t, "tiered_nout", cot, plain=False)
    padded = np.concatenate([cot, np.zeros((810 - N_OUT, cot.shape[1]))])
    pos = t["pos"].clone().requires_grad_(True)
    h = t["box"].h.clone().requires_grad_(True)
    out, _ = tasn.angular_aev_asn(
        ang["tspec"], t["grid"], t["bins"], ang["ta"], pos,
        Box(h=h, origin=t["box"].origin), ang["sections"],
        ang["caps"]["sized"], tiers=ang["tiers"]["ladder"], compact_cols=True)
    ref = torch.autograd.grad((out * torch.tensor(padded)).sum(), (pos, h))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r.numpy(), rtol=0,
                                   atol=1e-12 * float(r.abs().max()))
    assert (np.abs(got[0][N_OUT:]).sum(1) > 0).sum() > 100


def test_angular_wrappers_count_plain_calls_on_the_cpu(ang):
    """On CPU tensors the per-channel wrappers run their plain versions
    and count them (one packed call per tier); nothing is launched and no
    fused kernel is touched."""
    _, t = ang["sys"][torch.float64]
    tasn.reset_counts()
    _port_grads(ang, t, "tiered_nout", ang["cots"]["tiered_nout"],
                plain=False)
    want = dict.fromkeys(tasn.LAUNCHES, 0)
    want.update(compact_asn=1, packed_fwd=3, packed_bwd=3, decompact_chain=1,
                wing=1)
    assert tasn.PLAIN_CALLS == want
    assert not any(tasn.LAUNCHES.values())
