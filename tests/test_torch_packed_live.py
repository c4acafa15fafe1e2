"""The algebra the packed pair kernels rely on (lammps_ani_torch/csrc/
aev_asn.cu, `asn_packed_fwd_kernel` and `asn_packed_bwd_kernel`), held on
the plain versions. The kernels walk each arm's live prefix only and give
the parked slots their fc cotangent from a closed form; chip_smoke.py holds
the kernels themselves against the plain versions on the card.

System: WATER30 x 3^3 (810 atoms, 24 A box), jittered by a seeded normal
(0.05 A), sorted by species; one coarse roll grid of bin side >= Rcr +
skin = 7.1 A at cap 40, sections and angular caps with the JAX engine's
margins (as tests/test_torch_asn_build.py sizes them); two occupancy tiers
((caps - 4, n / 2), (caps, n)). Rows: the flat rows the plain forward
hands to each tier's packed call, in f64 and in f32.

A parked slot: u = 0, d = big = 2 Rca + 10 and fc = 0 exactly.
"""

import math

import numpy as np
import pytest
import torch

from lammps_ani_torch.models import aev as taev
from lammps_ani_torch.ops import aev_asn as tasn
from lammps_ani_torch.ops import aev_roll as tar
from lammps_ani_torch.ops import cell_roll as tcr
from lammps_ani_torch.ops import neighbors as tnb

from .fixtures import WATER30_BOX, WATER30_ORIGIN, WATER30_POS, WATER30_SPECIES

KEEP_R = 7.1  # Rcr 5.1 + skin 2.0
CAP = 40
DTYPES = {"f64": torch.float64, "f32": torch.float32}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the plain versions are chains of small tensor
    operations, and test processes share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(rep=3, jitter=0.05, seed=3):
    """(species, positions, box_h, origin) of WATER30 x rep^3, jittered,
    sorted by species."""
    shifts = [np.array([i, j, k]) @ WATER30_BOX for i in range(rep)
              for j in range(rep) for k in range(rep)]
    pos = np.concatenate([WATER30_POS + s for s in shifts])
    pos = pos + jitter * np.random.default_rng(seed).standard_normal(
        pos.shape)
    species = np.tile(WATER30_SPECIES, rep ** 3)
    order = np.argsort(species, kind="stable")
    return species[order], pos[order], WATER30_BOX * rep, WATER30_ORIGIN


def _degrees(species, pos, h, radius):
    """[n, 7] per-species neighbor counts within `radius` (minimum image,
    self excluded)."""
    side = np.diag(h)
    d = pos[:, None, :] - pos[None, :, :]
    d -= side * np.round(d / side)
    r2 = np.einsum("ijk,ijk->ij", d, d)
    np.fill_diagonal(r2, np.inf)
    within = r2 <= radius * radius
    return np.stack([(within & (species == s)[None, :]).sum(1)
                     for s in range(7)], axis=1)


@pytest.fixture(scope="module")
def system():
    species, pos, h, origin = _system()
    spec = taev.ani2x_aev_spec()
    sections = tasn.sections_from_degrees(
        _degrees(species, pos, h, KEEP_R).max(0), 1.1)
    kpad = tasn._round_lane(sum(k for _, k in sections) + 1)
    cnt = _degrees(species, pos, h, spec.angular_cutoff).max(0)
    caps = tuple(0 if d == 0 else -(-int(
        d * 1.1 + 2 + (4 if d * 1.1 <= 10 else 0)) // 4) * 4 for d in cnt)
    n = len(species)
    caps0 = tuple(max(4, c - 4) if c else 0 for c in caps)
    return dict(species=species, pos=pos, h=h, origin=origin, spec=spec,
                sections=sections, kpad=kpad, caps=caps,
                tiers=((caps0, n // 2), (caps, n)))


@pytest.fixture(scope="module", params=list(DTYPES), ids=list(DTYPES))
def rows(request, system):
    """Each tier's flat rows from the plain forward, with a seeded
    cotangent of its columns: [(cat_t, caps_t, ga_t)]."""
    s, dtype = system, DTYPES[request.param]
    box = tnb.Box(h=torch.tensor(s["h"], dtype=dtype),
                  origin=torch.tensor(s["origin"], dtype=dtype))
    pos = tnb.wrap_positions(torch.tensor(s["pos"], dtype=dtype), box)
    grid = tcr.RollGrid.for_box(s["h"], KEEP_R, CAP)
    bins = tcr.build_bins(grid, pos, torch.tensor(s["species"]), box)
    a = tasn.build_assignment(grid, bins, pos, box, s["sections"], s["kpad"],
                              KEEP_R)
    static = (s["spec"], tuple(grid.ncells), s["sections"], s["caps"],
              s["tiers"], None, "packed")
    _, (_, _, part) = tasn._forward(static, pos, box.h, bins.inv,
                                    bins.species_grid, bins.cell, bins.slot,
                                    a.idx, tasn._PLAIN)
    a_offs, atot = tasn._a_offsets(s["sections"], s["caps"])
    rng = np.random.default_rng(11)
    ncols = 32 * len(tasn.present_channels(s["spec"], s["caps"],
                                           s["sections"]))
    tiers = [(cat, caps_t, torch.tensor(rng.standard_normal(
        (cat.shape[0], ncols)), dtype=dtype))
        for (caps_t, _), cat in zip(part["tiers"], part["cats"])]
    big = 2.0 * s["spec"].angular_cutoff + 10.0
    return dict(tiers=tiers, a_offs=a_offs, atot=atot, big=big,
                spec=s["spec"], dtype=dtype)


def _parked(cat, atot, big):
    """[rows, atot] bool: the parked slots."""
    c = cat.reshape(cat.shape[0], 5, atot)
    return ((c[:, 0] == 0) & (c[:, 1] == 0) & (c[:, 2] == 0)
            & (c[:, 3] == big) & (c[:, 4] == 0))


def _lane_terms(r, cat, caps_t):
    """(pair terms of every pair lane, lane table [q, 3], [rows, q] bool:
    the lane has a parked slot)."""
    atot = r["atot"]
    tab = tasn._lane_table(r["spec"], caps_t, r["a_offs"], "cpu").long()
    i1, i2 = tab[:, 0], tab[:, 1]
    c = cat.reshape(-1, 5, atot)
    u = c[:, 0:3]
    cst = tar.angular_consts(r["spec"], cat.dtype)
    pt = tar._pair_terms_core(
        cst, u[:, :, i1].transpose(1, 2), u[:, :, i2].transpose(1, 2),
        c[:, 3, i1], c[:, 3, i2], c[:, 4, i1], c[:, 4, i2])
    parked = _parked(cat, atot, r["big"])
    return pt, tab, parked[:, i1] | parked[:, i2], cst


@pytest.mark.parametrize("tier", [0, 1])
def test_filled_slots_form_a_prefix_and_the_rest_is_parked(rows, tier):
    """In every section of every row the slots that are not parked come
    first; every slot after them is parked exactly, and the filled ones lie
    within Rca (or at d = big with u != 0: a neighbor at distance <= 1e-6)."""
    cat, _, _ = rows["tiers"][tier]
    atot, big = rows["atot"], rows["big"]
    parked = _parked(cat, atot, big)
    d = cat.reshape(cat.shape[0], 5, atot)[:, 3]
    n_parked = n_filled = 0
    for off, a_s in rows["a_offs"].values():
        p = parked[:, off:off + a_s]
        # once parked, parked to the end of the section
        assert torch.equal(p, torch.cummax(p.int(), dim=1).values.bool())
        filled = ~p
        d_f = d[:, off:off + a_s][filled]
        assert bool(((d_f <= rows["spec"].angular_cutoff)
                     | (d_f == big)).all())
        n_parked += int(p.sum())
        n_filled += int(filled.sum())
    assert n_parked > 0 and n_filled > 0


@pytest.mark.parametrize("tier", [0, 1])
def test_forward_without_parked_pairs_is_unchanged(rows, tier):
    """`packed_fwd_plain` equals the column sums over the pair lanes with
    both slots live: a lane with a parked slot adds exactly 0 (f64: 1e-15
    of the largest column; f32: 1e-7, a few ulps of sums taken in another
    order)."""
    cat, caps_t, _ = rows["tiers"][tier]
    ref = tasn.packed_fwd_plain(cat, rows["spec"], caps_t, rows["a_offs"])
    pt, tab, dead, _ = _lane_terms(rows, cat, caps_t)
    blocks, _, _ = tasn._packed_layout(rows["spec"], caps_t, rows["a_offs"])
    pmin = 1e-30 if cat.dtype == torch.float32 else 0.0
    cols = []
    for blk in blocks:
        lo = blk[8]
        hi = lo + (blk[5] * (blk[5] - 1) // 2 if blk[7] else blk[5] * blk[6])
        live = ~dead[:, lo:hi]
        for e in pt["e_j"]:
            for f1 in pt["f1_m"]:
                v = pt["fc12"][:, lo:hi] * e[:, lo:hi] * f1[:, lo:hi]
                v = torch.where(live & (v > pmin), v, 0.0)
                cols.append(v.sum(-1))
    got = 2.0 * torch.stack(cols, dim=-1)
    assert bool(dead.any()) and float(ref.abs().max()) > 0
    tol = 1e-15 if cat.dtype == torch.float64 else 1e-7
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=tol * float(ref.abs().max()))


def _arm_slots(rows, caps_t):
    """[(off1, a1, off2, a2, same)] of the tier's blocks."""
    blocks, _, _ = tasn._packed_layout(rows["spec"], caps_t, rows["a_offs"])
    return [(b[3], b[5], b[4], b[6], b[7]) for b in blocks]


@pytest.mark.parametrize("tier", [0, 1])
def test_backward_without_parked_pairs_is_unchanged_on_live_slots(rows,
                                                                  tier):
    """`packed_bwd_plain`'s five sums of every live slot equal the sums over
    the pair lanes with both slots live (f64: 1e-13 of the field's largest
    entry; f32: 1e-6), and a parked slot gets no u or d cotangent."""
    cat, caps_t, ga = rows["tiers"][tier]
    atot = rows["atot"]
    ref = tasn.packed_bwd_plain(cat, ga, rows["spec"], caps_t,
                                rows["a_offs"]).reshape(-1, 5, atot)
    pt, tab, dead, cst = _lane_terms(rows, cat, caps_t)
    blocks, _, _ = tasn._packed_layout(rows["spec"], caps_t, rows["a_offs"])
    g = 2.0 * ga.reshape(-1, len(blocks), cst["n_a"],
                         len(cst["cos_m"]))[:, tab[:, 2]]
    dcos, drmean, dfc12 = tasn._pair_grads(cst, pt, g)
    keep = ~dead
    dcos, drmean, dfc12 = (torch.where(keep, x, 0.0)
                           for x in (dcos, drmean, dfc12))
    got = cat.new_zeros((cat.shape[0], 5, atot))
    for i_own, u_other, fc_other in ((tab[:, 0], pt["u2"], pt["fc2"]),
                                     (tab[:, 1], pt["u1"], pt["fc1"])):
        arm = torch.cat([(dcos[..., None] * u_other).transpose(1, 2),
                         (0.5 * drmean)[:, None],
                         (dfc12 * fc_other)[:, None]], dim=1)
        got.index_add_(2, i_own, arm)
    live = ~_parked(cat, atot, rows["big"])
    tol = 1e-13 if cat.dtype == torch.float64 else 1e-6
    for f in range(5):
        r, x = ref[:, f][live], got[:, f][live]
        assert float(r.abs().max()) > 0
        torch.testing.assert_close(x, r, rtol=0,
                                   atol=tol * float(r.abs().max()))
    assert not ref[:, :4].permute(0, 2, 1)[~live].any()


@pytest.mark.parametrize("tier", [0, 1])
def test_parked_fc_cotangent_is_cb_times_live_partners_fc(rows, tier):
    """A parked slot's fc cotangent is, summed over the blocks whose arm
    holds it, C_b times the sum of fc over the live slots of the block's
    other arm (its own arm for one species): C_b is dfc12 of the parked
    pair (u = 0, d = big, fc = 0 on both arms), whose cosine is 0 and whose
    radial mean is clamped to Rca + 1 (f64: 1e-12 of the largest entry;
    f32: 2e-6). Slots in no arm get 0."""
    cat, caps_t, ga = rows["tiers"][tier]
    atot, big, dtype = rows["atot"], rows["big"], cat.dtype
    ref = tasn.packed_bwd_plain(cat, ga, rows["spec"], caps_t,
                                rows["a_offs"]).reshape(-1, 5, atot)[:, 4]
    cst = tar.angular_consts(rows["spec"], dtype)
    zero = cat.new_zeros((cat.shape[0], 1))
    pt = tar._pair_terms_core(cst, cat.new_zeros((1, 3)),
                              cat.new_zeros((1, 3)), zero + big, zero + big,
                              zero, zero)
    parked = _parked(cat, atot, big)
    fc = cat.reshape(-1, 5, atot)[:, 4]
    want = cat.new_zeros((cat.shape[0], atot))
    for b, (off1, a1, off2, a2, same) in enumerate(_arm_slots(rows, caps_t)):
        g = 2.0 * ga[:, 32 * b:32 * (b + 1)].reshape(-1, cst["n_a"],
                                                     len(cst["cos_m"]))
        _, _, c_b = tasn._pair_grads(cst, pt, g[:, None])
        c_b = c_b[:, 0]
        arms = ((off1, a1, off1, a1),) if same else (
            (off1, a1, off2, a2), (off2, a2, off1, a1))
        for off, a, po, pa in arms:
            live_fc = torch.where(parked[:, po:po + pa], 0.0,
                                  fc[:, po:po + pa]).sum(1)
            want[:, off:off + a] += torch.where(
                parked[:, off:off + a], (c_b * live_fc)[:, None], 0.0)
    assert bool(parked.any()) and float(want.abs().max()) > 0
    tol = 1e-12 if dtype == torch.float64 else 2e-6
    torch.testing.assert_close(ref[parked], want[parked], rtol=0,
                               atol=tol * float(ref.abs().max()))


def _split_pow(b, zeta):
    """The f32 power of `zeta_pow_split` (csrc/aev_asn.cu) on PyTorch's
    log2 and exp2: b^n 2^(f log2 b), the integer part b^n = r s + (k e) r
    on the rounded square s = b b and its exact error e, r = s^(k-1)
    b^(n & 1), k = n >> 1. An fma rounds once: it is taken in f64 and
    rounded to f32."""
    n = math.floor(zeta)
    frac = torch.tensor(zeta - n, dtype=torch.float32)
    k = n >> 1
    r = b.clone() if n & 1 else torch.ones_like(b)
    if k > 0:
        s = b * b
        err = (b.double() * b.double() - s.double()).float()
        sq, e = s.clone(), k - 1
        while e:
            if e & 1:
                r = r * sq
            if e > 1:
                sq = sq * sq
            e >>= 1
        r = ((k * err).double() * r.double() + (r * s).double()).float()
    return r * torch.exp2(frac * torch.log2(b))


@pytest.mark.parametrize("zeta", [14.1, 13.3, 1.7],
                         ids=["ani2x", "odd_floor", "floor_one"])
def test_f32_split_power_against_f64_pow(zeta):
    """Over base in [0.025, 1] (the angle factor's range holds base >=
    0.066), the f32 split power is within 5e-7 relative of the f64 pow."""
    b = torch.linspace(0.025, 1.0, 1_000_001, dtype=torch.float64).float()
    got = _split_pow(b, zeta).double()
    ref = b.double() ** zeta
    rel = ((got - ref) / ref).abs().max()
    assert float(rel) <= 5e-7, float(rel)
