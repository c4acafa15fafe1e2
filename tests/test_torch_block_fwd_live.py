"""The live-pair walk of the per-block forwards (lammps_ani_torch/csrc/
aev_asn.cu, `block_fwd_row` through `block_pairs_fwd`, the packed
forward's own pair pass without its flush of tiny terms), transcribed in
torch and held against the plain versions (`block_fwd_tri_plain`,
`block_fwd_plain`) and the JAX package's per-block forward kernels
(`_run_fwd_blocks` under LAT_ANG_PACKED=0, LAT_ANG_TRI at 1 and at 0,
interpret mode). chip_smoke.py holds the kernels themselves against the
plain versions on the card.

Per row and block, the kernel stages the block's slots (one row of a1
slots for one species, a1 + a2 for two) and:
  * finds each arm's live prefix by ballot: one past the last slot that is
    not parked (a parked slot: u = 0, d = big = 2 Rca + 10, fc = 0);
  * gives the live pairs to the lanes, pair t to lane t mod 32 in order
    (one species: the triangle of the n1 live slots row by row; two
    species: the n1 x n2 rectangle), each adding its 32 column terms fc12
    e_j f1_m as they come (no flush of tiny terms: packed_fwd's `c >
    pmin` test is compiled out);
  * reduce-scatters the 32 sums over the warp (lane l ends with column l)
    and writes 2 x column l.
The full same-species form ("blocks_full": ordered pairs at scale 1) goes
through the same triangle at scale 2: its pairs (j, k) and (k, j) have the
same terms. In f32 the power is the split form (tests/test_torch_packed_
live.py); f64 takes exp(zeta log base); the Gaussians are expf in both.

System and rows: tests/test_torch_block_bwd_live.py's (WATER30 x 3^3, 810
atoms, jittered, sorted; caps H 20 / O 16, f64): the first 48 flat rows of
the plain forward, 4 with every slot parked, 4 with the O section parked,
4 with the H section parked, and 4 with a live H slot filled as stage 2
fills a neighbour at distance <= 1e-6 (u != 0, d = big, fc = 0). Limits:
f64 against the plain versions and JAX 1e-12 of the largest entry; parked
rows and blocks exactly 0; f32 within 0.25 of chip_smoke's gate (5e-6 +
1e-5 x the largest entry) of the plain f32 version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ani_tpu.models import aev as jaev
from lammps_ani_tpu.ops import aev_asn as jasn
from lammps_ani_torch.ops import aev_asn as tasn
from lammps_ani_torch.ops import aev_roll as tar

from .test_torch_asn_blocks import SWITCH, _switched
from .test_torch_block_bwd_live import ROWS, gate, live_len, live_rows
from .test_torch_packed_live import _split_pow
from .test_torch_roll_angular_fwd_order import reduce_scatter32

DTYPES = {"f64": torch.float64, "f32": torch.float32}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair_columns(cst, u1, u2, d1, d2, fc1, fc2):
    """[q, 32] column terms fc12 e_j f1_m (column j*8 + m) of q pairs (u
    [q, 3], d and fc [q]), in the order of `pair_terms_geom` (expf
    Gaussians) and `pair_powers` (f32: the split power)."""
    dtype = d1.dtype

    def c(v):
        return torch.tensor(v, dtype=dtype)

    cq = u1[:, 0] * u2[:, 0] + u1[:, 1] * u2[:, 1] + u1[:, 2] * u2[:, 2]
    c95 = c(0.95) * torch.clamp(cq, -1.0, 1.0)
    sv = torch.sqrt(c(1.0) - c95 * c95)
    fc12 = fc1 * fc2
    x2 = torch.minimum(c(0.5) * (d1 + d2), c(cst["rca"]) + c(1.0)) - c(
        cst["mu0"])
    e = []
    for j in range(4):
        xj = x2 - c(float(j)) * c(cst["delta"])
        arg = c(-cst["eta"]) * (xj * xj)
        e.append(torch.where(arg > c(cst["tiny"]), torch.exp(arg), c(0.0)))
    f1 = []
    for cm, sm in zip(cst["cos_m"], cst["sin_m"]):
        b = c(0.5) * (c(1.0) + c95 * c(cm) + sv * c(sm))
        f1.append(_split_pow(b, cst["zeta"]) if dtype == torch.float32
                  else torch.exp(c(cst["zeta"]) * torch.log(b)))
    return torch.stack([(fc12 * ej) * f for ej in e for f in f1], -1)


def emulate_block(cst, row, arms, same, big, pmin=None):
    """[32] one row's block columns as the kernel computes them: row [5,
    atot] the slots' fields, arms ((off1, a1), (off2, a2)); `pmin`: add a
    term only above it (packed_fwd's flush, for contrast)."""
    (off1, a1), (off2, a2) = arms
    u = row[0:3].T
    d, fc = row[3], row[4]
    n1 = live_len(u[off1:off1 + a1], d[off1:off1 + a1], fc[off1:off1 + a1],
                  big)
    n2 = n1 if same else live_len(u[off2:off2 + a2], d[off2:off2 + a2],
                                  fc[off2:off2 + a2], big)
    if same:
        jk = torch.triu_indices(n1, n1, 1)  # row by row: pair t
        j, k = jk[0], jk[1]
    else:
        j = torch.arange(n1).repeat_interleave(n2)
        k = torch.arange(n2).repeat(n1)
    i1, i2 = off1 + j, off2 + k
    terms = pair_columns(cst, u[i1], u[i2], d[i1], d[i2], fc[i1], fc[i2])
    if pmin is not None:
        terms = torch.where(terms > pmin, terms, 0.0)
    acc = torch.zeros((32, 32), dtype=row.dtype)
    for r0 in range(0, terms.shape[0], 32):
        blk = terms[r0:r0 + 32]
        acc[:blk.shape[0]] = acc[:blk.shape[0]] + blk
    return 2.0 * reduce_scatter32(acc)


def emulate_stage(spec, cat, caps, a_offs, stage, pmin=None):
    """[rows, n_blocks 32] of the stage's forward launches."""
    cst = tar.angular_consts(spec, cat.dtype)
    big = 2.0 * cst["rca"] + 10.0
    rows, w5 = cat.shape
    c = cat.reshape(rows, 5, w5 // 5)
    cols = []
    for kind, args in tasn._stage_blocks(spec, caps, a_offs, stage):
        if kind == "zero":
            cols.append(cat.new_zeros((rows, 32)))
            continue
        if kind == "tri":
            arms, same = ((args[0], args[1]), (args[0], args[1])), True
        else:
            off1, a1, off2, a2, same = args
            arms = ((off1, a1), (off2, a2))
        cols.append(torch.stack([emulate_block(cst, c[r], arms, same, big,
                                               pmin)
                                 for r in range(rows)]))
    return torch.cat(cols, 1)


def plain_stage(spec, cat, caps, a_offs, stage):
    cols = []
    for kind, args in tasn._stage_blocks(spec, caps, a_offs, stage):
        if kind == "tri":
            cols.append(tasn.block_fwd_tri_plain(cat, spec, *args))
        elif kind == "block":
            cols.append(tasn.block_fwd_plain(cat, spec, *args))
        else:
            cols.append(cat.new_zeros((cat.shape[0], 32)))
    return torch.cat(cols, 1)


def jax_stage(spec, cat, caps, a_offs, stage):
    """The JAX per-block forward kernels (`_run_fwd_blocks`) on the same
    rows: [rows, n_blocks 32], channel order."""
    atot = cat.shape[1] // 5
    rows = cat.shape[0]
    cfl = [jnp.asarray(cat[:, f * atot:(f + 1) * atot].numpy())
           for f in range(5)]
    with _switched(stage):
        pieces = jasn._run_fwd_blocks(jaev.ani2x_aev_spec(), caps, a_offs,
                                      cfl, rows, rows, True, jnp.float64)
    return torch.from_numpy(np.concatenate(
        [np.asarray(pieces[ch]) for ch in sorted(pieces)], 1))


def with_tiny_fc(cat, a_offs, atot, big, fc_small):
    """Two rows of `cat` whose H-H block keeps only its first two slots,
    live with fc = fc_small (every term below 1e-30 at fc_small 1e-16),
    the rest of the row parked."""
    c = cat[:2].clone().reshape(2, 5, atot)
    off_h, a_h = a_offs[0]
    keep = c[:, :, off_h:off_h + 2].clone()
    c[:] = 0.0
    c[:, 3] = big
    c[:, :, off_h:off_h + 2] = keep
    c[:, 4, off_h:off_h + 2] = fc_small
    return c.reshape(2, 5 * atot).contiguous()


@pytest.fixture(scope="module")
def rows():
    out = live_rows()
    spec, caps, a_offs, cat = (out["spec"], out["caps"], out["a_offs"],
                               out["cat"])
    for stage in SWITCH:
        for name, dtype in DTYPES.items():
            c = cat.to(dtype)
            out[stage, name] = dict(
                emulated=emulate_stage(spec, c, caps, a_offs, stage),
                plain=plain_stage(spec, c, caps, a_offs, stage))
        out[stage, "jax"] = jax_stage(spec, cat, caps, a_offs, stage)
    return out


def _col_blocks(rows, stage):
    """[(kind, species set)] of the stage's blocks, in column order."""
    sp_of = {off: s for s, (off, _) in rows["a_offs"].items()}
    out = []
    for kind, args in tasn._stage_blocks(rows["spec"], rows["caps"],
                                         rows["a_offs"], stage):
        offs = (args[0],) if kind == "tri" else (args[0], args[2])
        out.append({sp_of[o] for o in offs})
    return out


def test_rows_hold_the_cases(rows):
    """The rows hold live prefixes with parked slots after them, rows with
    every slot parked, sections with no live slot beside a live one, and a
    live slot at d = big with u != 0."""
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
    """The live walk (the full form through the triangle at scale 2)
    against the plain versions (every slot pair; the full form at scale
    1)."""
    got = rows[stage, "f64"]["emulated"]
    ref = rows[stage, "f64"]["plain"]
    scale = float(ref.abs().max())
    assert got.shape == ref.shape and scale > 0
    assert float((got - ref).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("stage", list(SWITCH))
def test_f64_transcription_matches_jax(rows, stage):
    got = rows[stage, "f64"]["emulated"]
    ref = rows[stage, "jax"]
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.parametrize("stage", list(SWITCH))
def test_parked_rows_and_blocks_give_exact_zeros(rows, stage):
    """A row with every slot parked has no live pair: its columns are
    exactly 0 (no pair is walked). A parked section zeroes every block
    with an arm in it, exactly; the other blocks agree with plain."""
    blocks = _col_blocks(rows, stage)
    for dtype in DTYPES:
        got = rows[stage, dtype]["emulated"]
        ref = rows[stage, dtype]["plain"]
        assert not got[ROWS:ROWS + 4].any() and not ref[ROWS:ROWS + 4].any()
        for blk, s in ((slice(ROWS + 4, ROWS + 8), 3),
                       (slice(ROWS + 8, ROWS + 12), 0)):
            for b, sps in enumerate(blocks):
                cols = got[blk, 32 * b:32 * (b + 1)]
                if s in sps:
                    assert not cols.any()
                else:
                    assert bool(cols.any())
    got = rows[stage, "f64"]["emulated"][ROWS + 4:ROWS + 12]
    ref = rows[stage, "f64"]["plain"][ROWS + 4:ROWS + 12]
    scale = float(rows[stage, "f64"]["plain"].abs().max())
    assert float((got - ref).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("stage", list(SWITCH))
def test_slot_at_tiny_distance_adds_exact_zeros(rows, stage):
    """A slot at d = big with u != 0 is live (fc = 0): its pairs add
    exactly 0, so its rows have the bits they have with the slot parked
    (the live prefix keeps its length), and agree with plain."""
    atot, slot = rows["atot"], rows["off_h"] + 1
    cat = rows["cat"][ROWS + 12:].clone()
    c = cat.reshape(-1, 5, atot)
    c[:, 0:3, slot] = 0.0
    got = rows[stage, "f64"]["emulated"][ROWS + 12:]
    parked = emulate_stage(rows["spec"], cat, rows["caps"], rows["a_offs"],
                           stage)
    assert torch.equal(got.view(torch.int64), parked.view(torch.int64))
    ref = rows[stage, "f64"]["plain"][ROWS + 12:]
    scale = float(rows[stage, "f64"]["plain"].abs().max())
    assert float((got - ref).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("stage", list(SWITCH))
def test_f32_transcription_within_the_gate(rows, stage):
    """f32: the split power, against the plain f32 version within 0.25 of
    the gate."""
    got = rows[stage, "f32"]["emulated"]
    want = rows[stage, "f32"]["plain"]
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= 0.25 * gate(scale), (err, gate(scale))


def test_tiny_terms_are_summed_not_flushed(rows):
    """f32 rows whose only live pairs have terms below packed_fwd's flush
    threshold (1e-30): the per-block walk sums them, as the plain version
    and the JAX kernel do, where packed_fwd's test would give zeros."""
    cat = with_tiny_fc(rows["cat"], rows["a_offs"], rows["atot"],
                       rows["big"], 1e-16).to(torch.float32)
    args = (rows["spec"], cat, rows["caps"], rows["a_offs"], "blocks")
    got = emulate_stage(*args)
    ref = plain_stage(*args)
    flushed = emulate_stage(*args, pmin=1e-30)
    assert 0.0 < float(got.abs().max()) < 1e-30
    assert not flushed.any()
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale
