"""The port's fused asn backward (`_AsnFused.backward`: radial_gamma,
packed_bwd, chain_sum, wing through their plain versions, and the glue
between them) vs the JAX package's and vs autograd.

System and sizing as test_torch_asn_build.py (810 atoms, 3x3x3 coarse
bins, f64); the port builds its own assignment and hands the same tables
to the JAX side. The cotangents of (radial, erep, angular) are seeded
numpy normals. Three independent references:

  * `jax.vjp` of `lammps_ani_tpu.ops.aev_asn.aev_asn_fused` in interpret
    mode (once per module, tiers off and on): atol 1e-11 of the largest
    entry;
  * torch.autograd through the port's plain forwards (`plain=True`), which
    never touches the explicit backward: atol 1e-12 of the largest entry
    (f64); in f32, 2e-6 of the largest entry (a few f32 ulps of sums
    taken in another order);
  * for `packed_bwd_plain`, the JAX kernel `_run_packed_bwd` in interpret
    mode on the same tier rows (1e-12 of the largest entry); for
    `wing_plain` and the fold, a brute scatter over the idx table.
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
from lammps_ani_torch.ops.neighbors import Box

from .test_torch_asn_build import KEEP_R, asn_system, grids, sizing

SYMBOLS = ("H", "C", "N", "O", "S", "F", "Cl")
TIERINGS = ("untiered", "tiered")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions are chains of small tensor operations. When
    several test processes share a machine, each with one OpenMP thread per
    core, those threads wait on one another at every operation and this
    file takes many times longer; one thread keeps its time flat."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cotangents(shapes, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def _port_grads(t, ta, spec, sizes, tiers, rep, cots, plain,
                dtype=torch.float64):
    """(dpos, dh) of sum(out * cotangent) through `aev_asn_fused`."""
    sections, caps = sizes
    pos = t["pos"].clone().requires_grad_(True)
    h = t["box"].h.clone().requires_grad_(True)
    out = tasn.aev_asn_fused(spec, t["grid"], t["bins"], ta, pos,
                             Box(h=h, origin=t["box"].origin), sections,
                             caps, tiers=tiers, repulsion=rep, plain=plain)
    e = sum((o * torch.tensor(c, dtype=dtype)).sum()
            for o, c in zip(out[:3], cots))
    dpos, dh = torch.autograd.grad(e, (pos, h))
    return dpos.numpy(), dh.numpy()


@pytest.fixture(scope="module")
def bwd():
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
    n = len(species)
    caps0 = tuple(max(4, c - 4) if c else 0 for c in caps)
    tiers = {"untiered": None, "tiered": ((caps0, n // 2), (caps, n))}
    srl = len(sections) * 16
    ncols = 32 * len(tasn.present_channels(tspec, caps, sections))
    cots = _cotangents([(n, srl), (n,), (n, ncols)])

    ref, got, oracle = {}, {}, {}
    for name, tr in tiers.items():
        def f(p, hh, tr=tr):
            return jasn.aev_asn_fused(
                jspec, j["grid"], j["bins"], ja, p,
                jnb.Box(h=hh, origin=j["box"].origin), sections, caps,
                tiers=tr, repulsion=jrs, interpret=True)[:3]

        _, vjp = jax.vjp(f, j["pos"], j["box"].h)
        ref[name] = [np.asarray(x) for x in vjp(tuple(jnp.asarray(c)
                                                      for c in cots))]
        args = (t, ta, tspec, (sections, caps), tr, trs, cots)
        got[name] = _port_grads(*args, plain=False)
        oracle[name] = _port_grads(*args, plain=True)
    return dict(ref=ref, got=got, oracle=oracle, t=t, ta=ta, tspec=tspec,
                jspec=jspec, trs=trs, sections=sections, caps=caps,
                kpad=kpad, tiers=tiers, cots=cots, species=species, pos=pos,
                h=h, origin=origin)


@pytest.mark.parametrize("which", [0, 1], ids=["dpos", "dh"])
@pytest.mark.parametrize("tiering", TIERINGS)
def test_backward_matches_jax_vjp(bwd, tiering, which):
    r, g = bwd["ref"][tiering][which], bwd["got"][tiering][which]
    assert g.shape == r.shape and np.abs(r).max() > 1.0
    np.testing.assert_allclose(g, r, rtol=0, atol=1e-11 * np.abs(r).max())


@pytest.mark.parametrize("which", [0, 1], ids=["dpos", "dh"])
@pytest.mark.parametrize("tiering", TIERINGS)
def test_backward_matches_autograd_through_plain_forwards(bwd, tiering,
                                                          which):
    r, g = bwd["oracle"][tiering][which], bwd["got"][tiering][which]
    np.testing.assert_allclose(g, r, rtol=0, atol=1e-12 * np.abs(r).max())


def test_backward_without_repulsion_matches_autograd(bwd):
    """With no repulsion spec the last radial column is 0 and carries no
    gradient, whatever its cotangent."""
    args = (bwd["t"], bwd["ta"], bwd["tspec"],
            (bwd["sections"], bwd["caps"]), None, None, bwd["cots"])
    got = _port_grads(*args, plain=False)
    ref = _port_grads(*args, plain=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12 * np.abs(r).max())
    assert np.abs(got[0] - bwd["got"]["untiered"][0]).max() > 1e-3


@pytest.mark.parametrize("which", [0, 1], ids=["dpos", "dh"])
def test_backward_f32_matches_autograd(bwd, which):
    """f32: the explicit backward and autograd through the plain forwards
    sum the same terms in another order: 2e-6 of the largest entry."""
    s = bwd
    _, t32 = grids(s["species"], s["pos"], s["h"], s["origin"],
                   torch.float32)
    args = (t32, s["ta"], s["tspec"], (s["sections"], s["caps"]),
            s["tiers"]["tiered"], s["trs"], s["cots"])
    got = _port_grads(*args, plain=False, dtype=torch.float32)[which]
    ref = _port_grads(*args, plain=True, dtype=torch.float32)[which]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())
    # and it is the f64 result to f32 accuracy
    np.testing.assert_allclose(got, s["got"]["tiered"][which], rtol=0,
                               atol=1e-5 * np.abs(ref).max())


# --- the four plain versions, one by one ------------------------------------


@pytest.fixture(scope="module")
def stages(bwd):
    """The backward's intermediate tensors (tiered): the forward's
    residuals, the radial part, the slot sums, the chained lanes."""
    s, t, ta = bwd, bwd["t"], bwd["ta"]
    static = (s["tspec"], tuple(t["grid"].ncells), s["sections"], s["caps"],
              s["tiers"]["tiered"], s["trs"], "packed")
    bins = t["bins"]
    _, (cmp, rank2, part) = tasn._forward(
        static, t["pos"], t["box"].h, bins.inv, bins.species_grid, bins.cell,
        bins.slot, ta.idx, tasn._KERNELS)
    g_rad, g_rep, g_ang = (torch.tensor(c) for c in s["cots"])
    pos_g, sp_g = tar._grid_inputs(bins.inv, t["pos"], bins.species_grid)
    ga = tar._to_grid_rows(bins.inv, torch.cat([g_rad, g_rep[:, None]], 1),
                           0.0)
    gr = tasn.radial_gamma_plain(pos_g, sp_g, t["box"].h, ta.idx, ga,
                                 t["grid"].ncells, s["tspec"], s["sections"],
                                 s["trs"])
    gsum = tasn._angular_gsum_grid(s["tspec"], s["sections"], s["caps"],
                                   len(s["species"]), bins.inv, g_ang, part,
                                   tasn._KERNELS)
    gt, fcen, dh = tasn.chain_sum_plain(rank2, ta.idx, cmp, gsum, gr,
                                        t["grid"].ncells, s["tspec"])
    return dict(cmp=cmp, rank2=rank2, part=part, gr=gr, gsum=gsum, gt=gt,
                fcen=fcen, dh=dh, g_ang=g_ang)


@pytest.mark.parametrize("field", range(5),
                         ids=["gux", "guy", "guz", "gd", "gfc"])
@pytest.mark.parametrize("tier", [0, 1])
def test_packed_bwd_matches_jax_kernel(bwd, stages, tier, field):
    """`packed_bwd_plain` vs the JAX kernel (`_run_packed_bwd`, interpret
    mode) on the rows the forward gathered for each tier, with that tier's
    cotangent rows."""
    s, part = bwd, stages["part"]
    caps_t, rows_t = part["tiers"][tier]
    cat = part["cats"][tier]
    a_offs, atot = tasn._a_offsets(s["sections"], s["caps"])
    n = len(s["species"])
    ga = torch.nn.functional.pad(stages["g_ang"],
                                 (0, 0, 0, part["pos_of"].shape[0] - n))
    ga_t = torch.where(part["valid"][tier][:, None],
                       ga[part["row_at"][tier]], 0.0)
    got = tasn.packed_bwd_plain(cat, ga_t, s["tspec"], caps_t, a_offs)
    got = got.reshape(rows_t, 5, atot)[:, field].numpy()
    key = ("packed_ref", tier)
    if key not in stages:
        chans = jasn.present_channels(s["jspec"], s["caps"], s["sections"])
        cfl = [jnp.asarray(cat[:, f * atot:(f + 1) * atot].numpy())
               for f in range(5)]
        stages[key] = jasn._run_packed_bwd(
            s["jspec"], caps_t, a_offs, atot, cfl, jnp.asarray(ga_t.numpy()),
            {ch0: i * 32 for i, ch0 in enumerate(chans)}, rows_t,
            jasn._r_flat(n), True, jnp.float64)
    ref = np.asarray(stages[key][field])
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_port_packed_columns_are_in_block_order(bwd):
    """The packed layout's blocks come in ascending channel offset: the
    forward's columns and the cotangent's need no reordering."""
    a_offs, _ = tasn._a_offsets(bwd["sections"], bwd["caps"])
    blocks, _, _ = tasn._packed_layout(bwd["tspec"], bwd["caps"], a_offs)
    assert tuple(b[2] for b in blocks) == tasn.present_channels(
        bwd["tspec"], bwd["caps"], bwd["sections"])


def test_wing_and_fold_match_a_brute_scatter(bwd, stages):
    """dpos of the lane cotangents gt: every live compact lane k of center
    (bin, slot) reads window lane w = idx[k], whose owner atom gets -gt and
    the center +gt. `wing_plain` + `_fold_wing` gather the same sums."""
    t, ta = bwd["t"], bwd["ta"]
    ncells, cap = t["grid"].ncells, t["grid"].cap
    gt = stages["gt"]
    wing = tasn.wing_plain(gt, ta.inv)
    got = tar._fold_wing(ncells, 1, stages["fcen"], wing).numpy()

    idx = ta.idx.numpy().astype(np.int64)
    nc, _, kpad = idx.shape
    wpad = ta.inv.shape[-1]
    g = gt.numpy().transpose(0, 1, 3, 2)  # [NC, cap, kpad, 3]
    ref = np.zeros((nc, cap, 3))
    live = idx < wpad
    b, a, k = np.nonzero(live)
    w = idx[b, a, k]
    off = np.stack(np.unravel_index(w // cap, (3, 3, 3)), 1) - 1
    bxyz = np.stack(np.unravel_index(b, ncells), 1)
    owner = np.ravel_multi_index(((bxyz + off) % np.asarray(ncells)).T,
                                 ncells)
    np.add.at(ref, (b, a), g[b, a, k])
    np.add.at(ref, (owner, w % cap), -g[b, a, k])
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    # Newton's third law: the lane cotangents move no center of mass
    np.testing.assert_allclose(got.sum((0, 1)), 0.0,
                               atol=1e-10 * np.abs(ref).max())


def test_dead_lanes_and_dead_slots_give_exact_zeros(bwd, stages):
    """Dead compact lanes (idx = wpad) get exactly 0 from radial_gamma
    and chain_sum; dead packed slots (d = 2 Rca + 10) get no u or d
    cotangent from packed_bwd; empty grid rows get no center force."""
    ta = bwd["ta"]
    dead = (ta.idx >= ta.inv.shape[-1])[:, :, None, :].expand_as(
        stages["gr"])
    assert dead.any() and not dead.all()
    assert not stages["gr"][dead].any()
    assert not stages["gt"][dead].any()
    assert stages["gt"][~dead].abs().max() > 0
    big = 2.0 * bwd["tspec"].angular_cutoff + 10.0
    dead_slot = (stages["cmp"][:, :, 3] == big)[:, :, None, :]
    assert dead_slot.any()
    assert not stages["gsum"][:, :, :4][dead_slot.expand(-1, -1, 4, -1)].any()
    empty = bwd["t"]["bins"].species_grid < 0
    assert empty.any() and not stages["fcen"][empty].any()


def test_an_all_dead_tier_gives_exact_zeros(bwd):
    """A tier no row was dealt to holds only dead-slot rows: its slot
    sums are exactly 0 whatever cotangent reaches it."""
    a_offs, atot = tasn._a_offsets(bwd["sections"], bwd["caps"])
    pad = tasn._tier_pad_row(atot, bwd["tspec"].angular_cutoff,
                             torch.float64, "cpu")
    cat = pad.expand(256, -1).contiguous()
    ncols = 32 * len(tasn.present_channels(bwd["tspec"], bwd["caps"],
                                           bwd["sections"]))
    ga = torch.tensor(np.random.default_rng(2).standard_normal((256, ncols)))
    out = tasn.packed_bwd_plain(cat, ga, bwd["tspec"], bwd["caps"], a_offs)
    assert out.shape == (256, 5 * atot) and not out.any()


def test_wrappers_count_plain_calls_on_the_cpu(bwd):
    """On CPU tensors every wrapper of the backward runs its plain version
    and counts it; nothing is launched."""
    tasn.reset_counts()
    _port_grads(bwd["t"], bwd["ta"], bwd["tspec"],
                (bwd["sections"], bwd["caps"]), bwd["tiers"]["tiered"],
                bwd["trs"], bwd["cots"], plain=False)
    assert tasn.PLAIN_CALLS == {"build_inv": 0, "build_idx": 0,
                                "step_fused": 1, "packed_fwd": 2,
                                "radial_gamma": 1, "packed_bwd": 2,
                                "chain_sum": 1, "wing": 1,
                                "radial_fwd_asn": 0, "compact_asn": 0,
                                "radial_bwd_asn": 0, "decompact_chain": 0,
                                "block_fwd": 0, "block_bwd": 0,
                                "block_fwd_tri": 0, "block_bwd_tri": 0}
    assert not any(tasn.LAUNCHES.values())
    assert set(tasn.REPLACES) == set(tasn.LAUNCHES)
