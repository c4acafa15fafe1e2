"""The port's asn assignment build and host-side layout (ops/aev_asn.py)
vs the JAX package's.

System: WATER30 replicated 3x3x3 (810 atoms, 24 A box), jittered by a
seeded normal (0.05 A), atoms sorted by species; one coarse roll grid of
bin side >= Rcr + skin = 7.1 A (3x3x3 bins) at cap 40. Sections and
angular caps are sized with the JAX engine's margins (sections x1.1;
caps x1.1 + 2, +4 if <= 10, rounded to 4). The JAX build runs its Pallas
kernels in interpret mode, once per module and dtype.

Integer outputs (the idx and inv tables, the overflows) must be equal;
the host-side searches and layouts must give the same tuples.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ani_tpu.models import aev as jaev
from lammps_ani_tpu.ops import aev_asn as jasn
from lammps_ani_tpu.ops import cell_roll as jcr
from lammps_ani_tpu.ops import neighbors as jnb
from lammps_ani_torch.models import aev as taev
from lammps_ani_torch.ops import aev_asn as tasn
from lammps_ani_torch.ops import cell_roll as tcr
from lammps_ani_torch.ops import neighbors as tnb

from .test_torch_neighbors import boxes, water_system

KEEP_R = 7.1  # Rcr 5.1 + skin 2.0
RCA = 3.5
CAP = 40

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: with several test processes on one machine, each
    with a thread per core, the threads wait on one another at every
    operation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def asn_system(rep=3, jitter=0.05, seed=3):
    """(species, positions, box_h, origin) of WATER30 x rep^3, jittered,
    sorted by species (the sorted MLP's order)."""
    species, pos, h, origin, _ = water_system(rep, jitter=jitter, seed=seed)
    order = np.argsort(species, kind="stable")
    return species[order], pos[order], h, origin


def degrees(species, pos, h, radius):
    """[n, 7] per-species neighbor counts within `radius` (minimum image
    in the cubic box, self excluded)."""
    side = np.diag(h)
    d = pos[:, None, :] - pos[None, :, :]
    d -= side * np.round(d / side)
    r2 = np.einsum("ijk,ijk->ij", d, d)
    np.fill_diagonal(r2, np.inf)
    within = r2 <= radius * radius
    return np.stack([(within & (species == s)[None, :]).sum(1)
                     for s in range(7)], axis=1)


def sizing(species, pos, h):
    """(sections, kpad, angular caps, [n, 7] within-Rca counts) with the
    JAX engine's margins."""
    keep = degrees(species, pos, h, KEEP_R).max(0)
    sections = tasn.sections_from_degrees(keep, 1.1)
    kpad = tasn._round_lane(sum(k for _, k in sections) + 1)
    cnt = degrees(species, pos, h, RCA)
    caps = tuple(0 if d == 0 else -(-int(
        d * 1.1 + 2 + (4 if d * 1.1 <= 10 else 0)) // 4) * 4
        for d in cnt.max(0))
    return sections, kpad, caps, cnt


def grids(species, pos, h, origin, dtype=torch.float64, cap=CAP):
    """JAX and port (pos, box, grid, bins) of one system."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jbox, tbox = boxes(h, origin)
    jbox = jnb.Box(h=jbox.h.astype(jdt), origin=jbox.origin.astype(jdt))
    tbox = tbox.to(dtype=dtype)
    jpos = jnb.wrap_positions(jnp.asarray(pos, jdt), jbox)
    tpos = tnb.wrap_positions(torch.tensor(pos, dtype=dtype), tbox)
    jgrid = jcr.RollGrid.for_box(h, KEEP_R, cap)
    tgrid = tcr.RollGrid.for_box(h, KEEP_R, cap)
    jbins = jcr.build_bins(jgrid, jpos, jnp.asarray(species), jbox)
    tbins = tcr.build_bins(tgrid, tpos, torch.tensor(species), tbox)
    assert int(tbins.count_max) <= cap
    return (dict(pos=jpos, box=jbox, grid=jgrid, bins=jbins),
            dict(pos=tpos, box=tbox, grid=tgrid, bins=tbins))


def build_both(j, t, sections, kpad):
    ja = jasn.build_assignment(j["grid"], j["bins"], j["pos"], j["box"],
                               sections, kpad, KEEP_R, interpret=True)
    ta = tasn.build_assignment(t["grid"], t["bins"], t["pos"], t["box"],
                               sections, kpad, KEEP_R)
    return ja, ta


@pytest.fixture(scope="module")
def system():
    species, pos, h, origin = asn_system()
    sections, kpad, caps, cnt = sizing(species, pos, h)
    return dict(species=species, pos=pos, h=h, origin=origin,
                sections=sections, kpad=kpad, caps=caps, cnt=cnt)


@pytest.fixture(scope="module", params=[torch.float64, torch.float32],
                ids=["f64", "f32"])
def built(request, system):
    s = system
    j, t = grids(s["species"], s["pos"], s["h"], s["origin"], request.param)
    return build_both(j, t, s["sections"], s["kpad"])


def test_system_sizing(system):
    """The sized system is the one the other tests assume: two species
    sections within one 128-lane kpad, H and O angular caps."""
    assert [s for s, _ in system["sections"]] == [0, 3]
    assert system["kpad"] == 128
    assert system["caps"][0] > 0 and system["caps"][3] > 0


@pytest.mark.parametrize("table", ["idx", "inv"])
def test_build_tables_equal_jax(built, table):
    ja, ta = built
    ref = np.asarray(getattr(ja, table))
    got = getattr(ta, table)
    assert got.dtype == torch.int16 and ref.dtype == np.int16
    np.testing.assert_array_equal(got.numpy(), ref)


def test_build_overflow_equals_jax(built):
    ja, ta = built
    np.testing.assert_array_equal(ta.ovf_sec.numpy(), np.asarray(ja.ovf_sec))
    assert float(ta.ovf) == float(ja.ovf) <= 0


def test_idx_inverts_inv(built):
    """Every live compact lane k maps to a window lane w whose inverse
    is k, and every kept window lane appears in idx once."""
    _, ta = built
    idx = ta.idx.to(torch.int64)
    inv = ta.inv.to(torch.int64)
    kpad, wpad = idx.shape[-1], inv.shape[-1]
    live = idx < wpad
    back = torch.gather(inv, 2, torch.where(live, idx, 0))
    lanes = torch.arange(kpad).expand_as(idx)
    assert torch.equal(back[live], lanes[live])
    assert int(live.sum()) == int((inv < kpad - 1).sum())


def test_tight_sections_overflow_agrees(system):
    """Sections below the measured degrees overflow: the per-species
    overflows agree with JAX (the tables are undefined there, on both
    sides, and are not compared)."""
    s = system
    j, t = grids(s["species"], s["pos"], s["h"], s["origin"])
    tight = tuple((sp, k // 2) for sp, k in s["sections"])
    ja, ta = build_both(j, t, tight, 128)
    np.testing.assert_array_equal(ta.ovf_sec.numpy(), np.asarray(ja.ovf_sec))
    assert float(ta.ovf) == float(ja.ovf) > 0


def test_build_rejects_a_kpad_below_the_sections(system):
    s = system
    _, t = grids(s["species"], s["pos"], s["h"], s["origin"])
    with pytest.raises(ValueError, match="kpad"):
        tasn.build_assignment(t["grid"], t["bins"], t["pos"], t["box"],
                              ((0, 100), (3, 40)), 128, KEEP_R)


# --- host-side sizing and layout ------------------------------------------


def test_sections_from_degrees_matches_jax(system):
    keep = degrees(system["species"], system["pos"], system["h"],
                   KEEP_R).max(0)
    for margin in (1.0, 1.1, 1.3):
        assert (tasn.sections_from_degrees(keep, margin)
                == jasn.sections_from_degrees(keep, margin))


def _count_matrices(system):
    """The system's within-Rca count matrix and seeded random ones (two
    and three present species)."""
    rng = np.random.default_rng(7)
    out = [(system["cnt"], system["caps"])]
    cnt = np.zeros((600, 7), np.int64)
    cnt[:, 0] = rng.integers(4, 21, 600)
    cnt[:, 1] = rng.integers(0, 9, 600)
    cnt[:, 3] = rng.integers(2, 13, 600)
    out.append((cnt, (24, 12, 0, 16, 0, 0, 0)))
    return out


def test_tier_searches_match_jax(system):
    for cnt, caps in _count_matrices(system):
        assert tasn.search_tiers(cnt, caps) == jasn.search_tiers(cnt, caps)
        for max_pre in (1, 2):
            assert (tasn.search_tier_ladder(cnt, caps, max_pre=max_pre)
                    == jasn.search_tier_ladder(cnt, caps, max_pre=max_pre))


@pytest.mark.parametrize("caps", [(20, 0, 0, 16, 0, 0, 0),
                                  (20, 0, 0, 0, 0, 0, 0),
                                  (12, 8, 0, 8, 0, 0, 0)])
def test_present_channels_and_packed_layout_match_jax(caps):
    tspec, jspec = taev.ani2x_aev_spec(), jaev.ani2x_aev_spec()
    sections = tuple((s, 40) for s in range(7) if caps[s])
    assert (tasn.present_channels(tspec, caps, sections)
            == jasn.present_channels(jspec, caps, sections))
    a_offs, atot = tasn._a_offsets(sections, caps)
    assert (a_offs, atot) == jasn._a_offsets(sections, caps)
    layout = tasn._packed_layout(tspec, caps, a_offs)
    assert layout == jasn._packed_layout(jspec, caps, a_offs)
    # the lane table enumerates each block's unordered slot pairs once
    blocks, q_total, _ = layout
    table = tasn._lane_table_np(tspec, caps, tuple(a_offs.items()))
    assert table.shape == (q_total, 3)
    for bi, (_, _, _, off1, off2, a1, a2, same, base) in enumerate(blocks):
        q = a1 * (a1 - 1) // 2 if same else a1 * a2
        rows = table[base:base + q]
        assert (rows[:, 2] == bi).all()
        pairs = {(int(x), int(y)) for x, y, _ in rows}
        assert len(pairs) == q
        if same:
            assert all(off1 <= x < y < off1 + a1 for x, y in pairs)
        else:
            assert all(off1 <= x < off1 + a1 and off2 <= y < off2 + a2
                       for x, y in pairs)


@pytest.mark.parametrize("case", ["fits", "cascade", "spill"])
def test_tier_partition_matches_jax(case):
    """pos_of, row_at, valid and spill of the port's cumsum/searchsorted
    partition equal the JAX two-level bisect's, on seeded count
    matrices (512 flat rows, 450 real)."""
    rng = np.random.default_rng({"fits": 1, "cascade": 2, "spill": 3}[case])
    n, n_pad2 = 450, 512
    cnts = np.stack([rng.integers(4, 21, n_pad2),
                     rng.integers(2, 17, n_pad2)], axis=1).astype(np.int32)
    caps = (20, 0, 0, 16, 0, 0, 0)
    tiers = {"fits": (((16, 0, 0, 12, 0, 0, 0), 512), (caps, 512)),
             "cascade": (((12, 0, 0, 8, 0, 0, 0), 128),
                         ((16, 0, 0, 12, 0, 0, 0), 256), (caps, 512)),
             "spill": (((12, 0, 0, 8, 0, 0, 0), 128), (caps, 256))}[case]
    ref = jasn._tier_partition(jnp.asarray(cnts), (0, 3), tiers, n)
    got = tasn._tier_partition(torch.tensor(cnts), (0, 3), tiers, n)
    real = np.arange(n_pad2) < n
    np.testing.assert_array_equal(got[0].numpy()[real],
                                  np.asarray(ref[0])[real])
    for g, r in zip(got[1], ref[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for g, r in zip(got[2], ref[2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[3]) == int(ref[3])
    assert (int(got[3]) > 0) == (case == "spill")
