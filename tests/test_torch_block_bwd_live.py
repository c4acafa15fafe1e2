"""The live-pair walk of the per-block backward (lammps_ani_torch/csrc/
aev_asn.cu, `block_bwd_row` through `block_pairs_bwd`, the packed
backward's own per-block passes), transcribed in torch and held against
the plain versions (`block_bwd_tri_plain`, `block_bwd_plain`) and the JAX
package's per-block kernels (`_run_bwd_blocks` under LAT_ANG_PACKED=0,
interpret mode). chip_smoke.py holds the kernels themselves against the
plain versions on the card.

Per row and block, the kernel stages the block's slots and:
  * finds each arm's live prefix by ballot: one past the last slot that is
    not parked (a parked slot: u = 0, d = big = 2 Rca + 10, fc = 0);
  * pass 1 gives the live pairs to the lanes (one species: the triangle of
    the n1 live slots row by row; two species: the n1 x n2 rectangle) and
    leaves each pair's dcos, drmean / 2 and dfc12 for the column cotangent
    at scale 2; one more lane takes the parked pair (u = 0, d = big, fc =
    0 on both arms), whose dfc12 is C_b, where a parked slot has a live
    partner;
  * pass 2 gives each live slot to one lane, which walks its live partners
    in index order with a running pair index (dcos u_partner, drmean / 2,
    dfc12 fc_partner), and each parked slot C_b times the live fc sum of
    the arm it pairs with (its own for one species; a warp sum);
  * adds each slot's five sums into acc in place.
The full same-species form ("blocks_full": ordered pairs at scale 1) goes
through the same triangle at scale 2: its pairs (j, k) and (k, j) have the
same terms. In f32 the power is the split form (tests/test_torch_packed_
live.py) and the divisions a x (1 / b) (__fdividef); f64 divides exactly
and takes exp(zeta log base).

System and rows: tests/test_torch_asn_build.py's (WATER30 x 3^3, 810
atoms, jittered, sorted; caps H 20 / O 16, f64), the first 48 flat rows of
the plain forward, then 16 rows made from them: 4 with every slot parked,
4 with the O section parked (the cross block's arm 2 has no live slot), 4
with the H section parked, and 4 with a live H slot filled as stage 2
fills a neighbour at distance <= 1e-6 (u = dvec / big != 0, d = big, fc =
0). Limits: f64 against the plain versions 1e-12 of the largest entry of
acc, against JAX 1e-12; parked rows, and the u and d sums of the slot at
distance <= 1e-6, exactly 0; f32 within 0.25 of chip_smoke's gate (5e-6 +
1e-5 x the largest entry) of the plain f32 version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ani_tpu.models import aev as jaev
from lammps_ani_tpu.ops import aev_asn as jasn
from lammps_ani_torch.models import aev as taev
from lammps_ani_torch.ops import aev_asn as tasn
from lammps_ani_torch.ops import aev_roll as tar

from .test_torch_asn_blocks import SWITCH, _switched
from .test_torch_asn_build import KEEP_R, asn_system, grids, sizing
from .test_torch_packed_live import _split_pow
from .test_torch_roll_radial_bwd_order import warp_sum

ROWS = 48


def gate(scale):
    return 5e-6 + 1e-5 * scale


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair_scalars(cst, u1, u2, d1, d2, fc1, fc2, gb):
    """(dcos, drmean / 2, dfc12) of q pairs (u [q, 3], d and fc [q]) for the
    column cotangent gb [32] (scale included), in the order of
    `pair_terms_geom`, `pair_powers` and `pair_cotangents<T, true>`."""
    dtype = d1.dtype
    f32 = dtype == torch.float32

    def c(v):
        return torch.tensor(v, dtype=dtype)

    def quot(a, b):
        return a * (1.0 / b.double()).to(dtype) if f32 else a / b

    cq = u1[:, 0] * u2[:, 0] + u1[:, 1] * u2[:, 1] + u1[:, 2] * u2[:, 2]
    cq = torch.clamp(cq, -1.0, 1.0)
    c95 = c(0.95) * cq
    sv = torch.sqrt(c(1.0) - c95 * c95)
    fc12 = fc1 * fc2
    dsum = d1 + d2
    rmean = c(0.5) * (d1 + d2)
    x2 = torch.minimum(rmean, c(cst["rca"]) + c(1.0)) - c(cst["mu0"])
    e = []
    for j in range(4):
        xj = x2 - c(float(j)) * c(cst["delta"])
        arg = c(-cst["eta"]) * (xj * xj)
        e.append(torch.where(arg > c(cst["tiny"]), torch.exp(arg), c(0.0)))
    base, f1 = [], []
    for cm, sm in zip(cst["cos_m"], cst["sin_m"]):
        b = c(0.5) * (c(1.0) + c95 * c(cm) + sv * c(sm))
        base.append(b)
        f1.append(_split_pow(b, cst["zeta"]) if f32
                  else torch.exp(c(cst["zeta"]) * torch.log(b)))
    df2 = [torch.zeros_like(d1) for _ in range(4)]
    dcos = torch.zeros_like(d1)
    for m in range(8):
        df1 = torch.zeros_like(d1)
        for j in range(4):
            gjm = gb[j * 8 + m]
            df1 = df1 + gjm * (fc12 * e[j])
            df2[j] = df2[j] + gjm * f1[m]
        dbase = df1 * quot(c(cst["zeta"]), base[m]) * f1[m]
        dcos = dcos + dbase * c(0.5) * (
            c(cst["cos_m"][m]) - quot(c95, sv) * c(cst["sin_m"][m])) * c(0.95)
    drmean = torch.zeros_like(d1)
    dfc12 = torch.zeros_like(d1)
    for j in range(4):
        drmean = drmean + df2[j] * fc12 * e[j] * c(-2.0 * cst["eta"]) * (
            x2 - c(float(j)) * c(cst["delta"]))
        dfc12 = dfc12 + df2[j] * e[j]
    drmean = torch.where(dsum <= c(2.0 * (cst["rca"] + 1.0)), drmean, 0.0)
    return dcos, c(0.5) * drmean, dfc12


def live_len(u, d, fc, big):
    """One past the last slot of an arm that is not parked."""
    live = ~((u == 0).all(-1) & (d == big) & (fc == 0))
    idx = torch.nonzero(live)
    return int(idx[-1]) + 1 if len(idx) else 0


def emulate_block(cst, row, ga_blk, arms, same, big, acc_row):
    """One row's per-block backward into acc_row [5, atot] in place: row
    [5, atot] the slots' fields, ga_blk [32], arms ((off1, a1), (off2,
    a2))."""
    (off1, a1), (off2, a2) = arms
    dtype = row.dtype
    gb = 2.0 * ga_blk
    u = row[0:3].T
    d, fc = row[3], row[4]
    sl1 = slice(off1, off1 + a1)
    sl2 = slice(off2, off2 + a2)
    n1 = live_len(u[sl1], d[sl1], fc[sl1], big)
    n2 = n1 if same else live_len(u[sl2], d[sl2], fc[sl2], big)
    if same:
        jk = torch.triu_indices(n1, n1, 1)
        j, k = jk[0], jk[1]  # row by row: pair t = tri index
    else:
        j = torch.arange(n1).repeat_interleave(n2)
        k = torch.arange(n2).repeat(n1)
    i1, i2 = off1 + j, off2 + k
    dcos, half, dfc12 = pair_scalars(cst, u[i1], u[i2], d[i1], d[i2],
                                     fc[i1], fc[i2], gb)
    want_cb = ((n1 < a1 and n1 > 0) if same else
               (n1 < a1 and n2 > 0) or (n2 < a2 and n1 > 0))
    c_fc1 = c_fc2 = torch.zeros((), dtype=dtype)
    if want_cb:
        z = torch.zeros((1, 3), dtype=dtype)
        bb = torch.full((1,), big, dtype=dtype)
        zz = torch.zeros(1, dtype=dtype)
        c_b = pair_scalars(cst, z, z, bb, bb, zz, zz, gb)[2][0]

        def fc_sum(off, n):
            lanes = torch.zeros(32, dtype=dtype)
            for c0 in range(0, n, 32):
                part = fc[off + c0:off + min(n, c0 + 32)]
                lanes[:len(part)] = lanes[:len(part)] + part
            return warp_sum(lanes)

        c_fc1 = c_b * fc_sum(off1, n1)
        c_fc2 = c_fc1 if same else c_b * fc_sum(off2, n2)

    def walk(slot_own, partners, pair_of):
        """Five sums of one live slot: its partners in index order."""
        g = torch.zeros(5, dtype=dtype)
        for p_slot, t in zip(partners, pair_of):
            g = g + torch.stack([dcos[t] * u[p_slot, 0],
                                 dcos[t] * u[p_slot, 1],
                                 dcos[t] * u[p_slot, 2], half[t],
                                 dfc12[t] * fc[p_slot]])
        acc_row[:, slot_own] += g

    if same:
        tri = {(int(a), int(b)): t for t, (a, b) in enumerate(zip(j, k))}
        for jj in range(n1):
            others = [kk for kk in range(n1) if kk != jj]
            walk(off1 + jj, [off1 + kk for kk in others],
                 [tri[min(jj, kk), max(jj, kk)] for kk in others])
    else:
        for jj in range(n1):
            walk(off1 + jj, [off2 + kk for kk in range(n2)],
                 [jj * n2 + kk for kk in range(n2)])
        for kk in range(n2):
            walk(off2 + kk, [off1 + jj for jj in range(n1)],
                 [jj * n2 + kk for jj in range(n1)])
    for jj in range(n1, a1):
        acc_row[4, off1 + jj] += c_fc2
    if not same:
        for kk in range(n2, a2):
            acc_row[4, off2 + kk] += c_fc1


def emulate_stage(spec, cat, ga, caps, a_offs, stage):
    """acc [rows, 5 atot] of the stage's backward launches, each block's
    sums added in block order (zeros in, as the force evaluation)."""
    cst = tar.angular_consts(spec, cat.dtype)
    big = 2.0 * cst["rca"] + 10.0
    rows, w5 = cat.shape
    atot = w5 // 5
    acc = torch.zeros((rows, 5, atot), dtype=cat.dtype)
    c = cat.reshape(rows, 5, atot)
    for i, (kind, args) in enumerate(tasn._stage_blocks(spec, caps, a_offs,
                                                        stage)):
        if kind == "zero":
            continue
        if kind == "tri":
            arms, same = ((args[0], args[1]), (args[0], args[1])), True
        else:
            off1, a1, off2, a2, same = args
            arms = ((off1, a1), (off2, a2))
        for r in range(rows):
            emulate_block(cst, c[r], ga[r, 32 * i:32 * (i + 1)], arms, same,
                          big, acc[r])
    return acc.reshape(rows, w5)


def plain_stage(spec, cat, ga, caps, a_offs, stage):
    acc = torch.zeros_like(cat)
    for i, (kind, args) in enumerate(tasn._stage_blocks(spec, caps, a_offs,
                                                        stage)):
        g = ga[:, 32 * i:32 * (i + 1)]
        if kind == "tri":
            tasn.block_bwd_tri_plain(cat, g, spec, *args, acc)
        elif kind == "block":
            tasn.block_bwd_plain(cat, g, spec, *args, acc)
    return acc


def jax_stage(jspec, spec, cat, ga, caps, a_offs, stage):
    """The JAX per-block backward kernels (`_run_bwd_blocks`) on the same
    rows: [rows, 5 atot]."""
    atot = cat.shape[1] // 5
    rows = cat.shape[0]
    chans = [ch0 for s1, s2, _, _, ch0, _ in tar._pair_blocks(spec, caps)
             if s1 in a_offs and s2 in a_offs]
    cfl = [jnp.asarray(cat[:, f * atot:(f + 1) * atot].numpy())
           for f in range(5)]
    with _switched(stage):
        gsum = jasn._run_bwd_blocks(
            jspec, caps, a_offs, atot, cfl, jnp.asarray(ga.numpy()),
            {ch0: 32 * i for i, ch0 in enumerate(chans)}, rows, rows, True,
            jnp.float64)
    return torch.from_numpy(np.concatenate([np.asarray(x) for x in gsum],
                                           1))


def live_rows():
    """The rows of this file (see the module docstring): dict(spec, caps,
    a_offs, atot, cat [64, 5 atot] f64, big, off_h)."""
    species, pos, h, origin = asn_system()
    sections, kpad, caps, _ = sizing(species, pos, h)
    _, t = grids(species, pos, h, origin)
    spec = taev.ani2x_aev_spec()
    ta = tasn.build_assignment(t["grid"], t["bins"], t["pos"], t["box"],
                               sections, kpad, KEEP_R)
    bins = t["bins"]
    static = (spec, tuple(t["grid"].ncells), sections, caps, None, True,
              "blocks")
    _, (_, _, part) = tasn._angular_forward(
        static, t["pos"], t["box"].h, bins.inv, bins.species_grid,
        bins.cell, bins.slot, ta.idx, tasn._KERNELS)
    a_offs, atot = tasn._a_offsets(sections, caps)
    base = part["cats"][0][:ROWS]
    big = 2.0 * spec.angular_cutoff + 10.0
    extra = base[:16].clone().reshape(16, 5, atot)
    extra[0:4] = 0.0
    extra[0:4, 3] = big
    for blk, s in ((slice(4, 8), 3), (slice(8, 12), 0)):
        off, a_s = a_offs[s]
        extra[blk, :, off:off + a_s] = 0.0
        extra[blk, 3, off:off + a_s] = big
    off_h = a_offs[0][0]
    tiny = extra[12:16, :, off_h + 1]
    tiny[:, 0:3] = torch.tensor([3e-8, -2e-8, 1e-8], dtype=torch.float64)
    tiny[:, 3] = big
    tiny[:, 4] = 0.0
    extra[12:16, :, off_h + 1] = tiny
    cat = torch.cat([base, extra.reshape(16, 5 * atot)]).contiguous()
    return dict(spec=spec, caps=caps, a_offs=a_offs, atot=atot, cat=cat,
                big=big, off_h=off_h)


@pytest.fixture(scope="module")
def rows():
    out = live_rows()
    spec, caps, a_offs, cat = (out["spec"], out["caps"], out["a_offs"],
                               out["cat"])
    n_blocks = len(tasn._stage_blocks(spec, caps, a_offs, "blocks"))
    ga = torch.from_numpy(np.random.default_rng(41).standard_normal(
        (cat.shape[0], 32 * n_blocks)))
    out["ga"] = ga
    for stage in SWITCH:
        for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            c, g = cat.to(dtype), ga.to(dtype)
            out[stage, name] = dict(
                emulated=emulate_stage(spec, c, g, caps, a_offs, stage),
                plain=plain_stage(spec, c, g, caps, a_offs, stage))
        out[stage, "jax"] = jax_stage(jaev.ani2x_aev_spec(), spec, cat, ga,
                                      caps, a_offs, stage)
    return out


def test_rows_hold_the_cases(rows):
    """The rows hold live prefixes with parked slots after them, rows with
    every slot parked, arms with no live slot beside a live one, and a live
    slot at d = big with u != 0."""
    c = rows["cat"].reshape(-1, 5, rows["atot"])
    big = rows["big"]
    parked = ((c[:, 0:3] == 0).all(1) & (c[:, 3] == big) & (c[:, 4] == 0))
    assert bool(parked[:ROWS].any()) and bool((~parked[:ROWS]).any())
    assert bool(parked[ROWS:ROWS + 4].all())
    for blk, s in ((slice(ROWS + 4, ROWS + 8), 3),
                   (slice(ROWS + 8, ROWS + 12), 0)):
        off, a_s = rows["a_offs"][s]
        assert bool(parked[blk, off:off + a_s].all())
        assert bool((~parked[blk]).any(1).all())
    slot = rows["off_h"] + 1
    assert not bool(parked[ROWS + 12:, slot].any())
    assert bool((c[ROWS + 12:, 3, slot] == big).all())


@pytest.mark.parametrize("stage", list(SWITCH))
def test_f64_transcription_matches_plain(rows, stage):
    got = rows[stage, "f64"]["emulated"]
    ref = rows[stage, "f64"]["plain"]
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((got - ref).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("stage", list(SWITCH))
def test_f64_transcription_matches_jax(rows, stage):
    got = rows[stage, "f64"]["emulated"]
    ref = rows[stage, "jax"]
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.parametrize("stage", list(SWITCH))
def test_parked_rows_and_arms(rows, stage):
    """Rows with every slot parked take exact zeros; a parked section
    beside a live one takes no u or d cotangent and an fc cotangent (C_b
    times the live arm's fc sum) equal to the plain version's."""
    atot = rows["atot"]
    for dtype in ("f64", "f32"):
        got = rows[stage, dtype]["emulated"].reshape(-1, 5, atot)
        ref = rows[stage, dtype]["plain"].reshape(-1, 5, atot)
        assert not got[ROWS:ROWS + 4].any() and not ref[ROWS:ROWS + 4].any()
    got = rows[stage, "f64"]["emulated"].reshape(-1, 5, atot)
    ref = rows[stage, "f64"]["plain"].reshape(-1, 5, atot)
    scale = float(ref.abs().max())
    for blk, s in ((slice(ROWS + 4, ROWS + 8), 3),
                   (slice(ROWS + 8, ROWS + 12), 0)):
        off, a_s = rows["a_offs"][s]
        g, r = got[blk, :, off:off + a_s], ref[blk, :, off:off + a_s]
        assert not g[:, 0:4].any()
        assert bool((g[:, 4] != 0).all())
        assert float((g - r).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("stage", list(SWITCH))
def test_slot_at_tiny_distance_is_live_and_gives_zeros(rows, stage):
    """A slot at d = big with u != 0 is live: its u and d sums are exactly
    0, and every other slot of its row agrees with the plain version."""
    atot, slot = rows["atot"], rows["off_h"] + 1
    got = rows[stage, "f64"]["emulated"].reshape(-1, 5, atot)[ROWS + 12:]
    ref = rows[stage, "f64"]["plain"].reshape(-1, 5, atot)[ROWS + 12:]
    assert not got[:, 0:4, slot].any()
    assert not ref[:, 0:4, slot].any()
    scale = float(rows[stage, "f64"]["plain"].abs().max())
    assert float((got - ref).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("stage", list(SWITCH))
def test_f32_transcription_within_the_gate(rows, stage):
    """f32: the split power and the fast divisions, against the plain f32
    version within 0.25 of the gate."""
    got = rows[stage, "f32"]["emulated"]
    want = rows[stage, "f32"]["plain"]
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= 0.25 * gate(scale), (err, gate(scale))
