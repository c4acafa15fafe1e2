"""The arithmetic of the roll engine's angular_fwd kernel (lammps_ani_torch/
csrc/aev_roll.cu, `angular_fwd_kernel`), transcribed in torch and held
against the plain version and the JAX package's `_angular_fwd_kernel`
(through `_angular_fwd_impl`, interpret mode). chip_smoke.py holds the
kernel itself against the plain version on the card.

The kernel stages each bin's 27-bin window once and compacts it in lane
order to its lanes of present species (the empty slots and absent species,
which no ballot below keeps, so no rank changes; transcribed here over the
whole window); a warp takes the bin's centers one at a time:
  * compaction by ballot (`compact_slots`, the backward's own): 32 window
    lanes at a time, one distance a lane, each species' in-Rca lanes ranked
    by popcount with a carry, the first caps[s] kept in ascending lane
    order; the deficit is the worst count - cap;
  * per species-pair block in torchani triu order, the live slot pairs
    only (the triangle of n1 filled slots, or the n1 x n2 rectangle), pair
    t on lane t mod 32, each lane adding its pairs' 32 channel terms in
    pair order, then a reduce-scatter of five shuffle steps that leaves
    channel l on lane l, written doubled;
  * every entry of the center's row is written: zeros in absent blocks
    and on a row with no atom.
In f32 the kernel takes the Gaussians as ex2(geta xj^2) (geta = -eta log2
e), the power by the split form (tests/test_torch_packed_live.py) and the
cutoff's cosine from the hardware (absolute error 2^-21.4 on [-pi, pi]):
here ex2 is taken exactly and the cosine's error is applied as a
worst-case perturbation.

System: WATER30 x 2^3 (240 atoms, 16 A box), a 3 x 3 x 3 fine grid (bin
side >= 4.5 A) at cap 16; angular caps H 20, O 12, and caps H 8, O 4 that
truncate. Limits: f64 against the plain version 1e-12 of the largest
magnitude, against JAX 1e-10; the deficit equal; f32 within chip_smoke's
gate (5e-6 + 1e-5 x the largest magnitude), here held to 0.25 of it
against the plain f32 version (measured 0.049-0.054 with the exact
cosine, 0.073-0.103 with the worst-case one), and against the f64 plain
version no worse than the plain f32 version (0.094-0.100 of the gate) plus
0.1 of the gate (measured up to +0.051).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ani_tpu.models import aev as jaev
from lammps_ani_tpu.ops import aev_pallas as jap
from lammps_ani_tpu.ops import cell_roll as jcr
from lammps_ani_tpu.ops import neighbors as jnb
from lammps_ani_torch.models import aev as taev
from lammps_ani_torch.ops import aev_roll as tar
from lammps_ani_torch.ops import cell_roll as tcr
from lammps_ani_torch.ops import neighbors as tnb

from .test_torch_build_inv_order import stage_window
from .test_torch_neighbors import boxes, water_system
from .test_torch_packed_live import _split_pow
from .test_torch_roll_angular_bwd_order import (CAP, CAPS, PRESENT, compact,
                                                tri_pair)

TRUNC = (8, 0, 0, 4, 0, 0, 0)
LOG2E = 1.4426950408889634
HW_TRIG_ERR = 2.0 ** -21.41  # __cosf on [-pi, pi] (CUDA guide)

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


def reduce_scatter32(acc):
    """The kernel's `reduce_scatter32` on acc [32 lanes, 32 columns], lane
    by lane as the shuffles run: returns [32], lane l's result."""
    lanes = torch.arange(32)
    for w in (16, 8, 4, 2, 1):
        upper = (lanes & w) != 0
        new = acc.clone()
        for i in range(w):
            send = torch.where(upper, acc[:, i], acc[:, i + w])
            keep = torch.where(upper, acc[:, i + w], acc[:, i])
            new[:, i] = keep + send[lanes ^ w]
        acc = new
    return acc[:, 0]


def pair_channels(cst, u1, u2, d1, d2, fc1, fc2, f32):
    """[q, 32] channel terms fc12 e_j f1_m (column j*8 + m) of q pairs: f64
    the plain pair terms (expf Gaussians, exp(zeta log base)); f32 as the
    kernel (ex2 Gaussians, the split power)."""
    if not f32:
        pt = tar._pair_terms_core(cst, u1, u2, d1, d2, fc1, fc2)
        e_j, f1_m, fc12 = pt["e_j"], pt["f1_m"], pt["fc12"]
    else:
        t = torch.float32

        def c(v):
            return torch.tensor(v, dtype=t)

        cq = torch.clamp((u1 * u2).sum(-1), -1.0, 1.0)
        c95 = c(0.95) * cq
        sv = torch.sqrt(c(1.0) - c95 * c95)
        fc12 = fc1 * fc2
        rmean = c(0.5) * (d1 + d2)
        x2 = torch.minimum(rmean, c(cst["rca"]) + c(1.0)) - c(cst["mu0"])
        geta, tiny2 = c(-cst["eta"] * LOG2E), c(cst["tiny"] * LOG2E)
        e_j = []
        for j in range(cst["n_a"]):
            xj = x2 - c(float(j)) * c(cst["delta"])
            y = geta * (xj * xj)
            e = torch.exp2(y.double()).to(t)
            e_j.append(torch.where(y > tiny2, e, c(0.0)))
        f1_m = []
        for cm, sm in zip(cst["cos_m"], cst["sin_m"]):
            base = c(0.5) * (c(1.0) + c95 * c(cm) + sv * c(sm))
            f1_m.append(_split_pow(base, cst["zeta"]))
    return torch.stack([(fc12 * e) * f1 for e in e_j for f1 in f1_m], -1)


def emulate_angular_fwd(pos_g, sp_g, h, ncells, spec, caps, present,
                        trig_err=0.0):
    """(out [NC, cap, angular_length], deficit, slot lanes) as the kernel
    computes them."""
    f32 = pos_g.dtype == torch.float32
    dtype = pos_g.dtype
    cst = tar.angular_consts(spec, dtype)
    nc, cap = sp_g.shape
    rca, big = cst["rca"], 2.0 * cst["rca"] + 10.0
    win_p, win_s = stage_window(pos_g, sp_g, h, ncells, present)
    lanes, carry, slot0 = compact(cst, caps, present, pos_g, win_p, win_s)
    atot = lanes.shape[-1]
    # the slots' fields: u, d (big where d <= 1e-6), fc
    filled = lanes >= 0
    cand = torch.gather(win_p, 1, torch.clamp(lanes, min=0).reshape(
        nc, cap * atot, 1).expand(-1, -1, 3)).reshape(nc, cap, atot, 3)
    dvec = pos_g[:, :, None, :] - cand
    dist = torch.sqrt(torch.clamp((dvec * dvec).sum(-1), min=1e-12))
    valid = filled & (dist > 1e-6)
    d_safe = torch.where(valid, dist, torch.tensor(big, dtype=dtype))
    u = dvec * (1.0 / d_safe)[..., None]
    arg = dist * torch.tensor(math.pi / rca, dtype=dtype)
    cos = ((torch.cos(arg.double()) + trig_err).to(dtype) if f32
           else torch.cos(arg))
    fc = torch.where(valid, 0.5 * cos + 0.5, 0.0)
    blocks = tar._pair_blocks(spec, caps)
    out = torch.zeros((nc, cap, spec.angular_length), dtype=dtype)
    deficit = tar.DEFICIT_FLOOR
    for cell in range(nc):
        for a in range(cap):
            if sp_g[cell, a] < 0:
                continue
            deficit = max(deficit, max(int(carry[s][cell, a]) - caps[s]
                                       for s in present))
            for s1, s2, _, _, ch0, same in blocks:
                n1 = min(int(carry[s1][cell, a]), caps[s1])
                n2 = min(int(carry[s2][cell, a]), caps[s2])
                q = n1 * (n1 - 1) // 2 if same else n1 * n2
                if q == 0:
                    continue
                pairs = [tri_pair(t, n1) if same else divmod(t, n2)
                         for t in range(q)]
                i1 = torch.tensor([slot0[s1] + j for j, _ in pairs])
                i2 = torch.tensor([slot0[s2] + k for _, k in pairs])
                su, sd, sf = u[cell, a], d_safe[cell, a], fc[cell, a]
                terms = pair_channels(cst, su[i1], su[i2], sd[i1], sd[i2],
                                      sf[i1], sf[i2], f32)
                # lane t mod 32 adds its pairs in pair order
                acc = torch.zeros((32, 32), dtype=dtype)
                for r0 in range(0, q, 32):
                    blk = terms[r0:r0 + 32]
                    acc[:blk.shape[0]] = acc[:blk.shape[0]] + blk
                out[cell, a, ch0:ch0 + 32] = 2.0 * reduce_scatter32(acc)
    return out, deficit, lanes


@pytest.fixture(scope="module")
def grid_case():
    species, pos, h, origin, _ = water_system(2)
    jbox, tbox = boxes(h, origin)
    jpos = jnb.wrap_positions(jnp.asarray(pos, jnp.float64), jbox)
    tpos = tnb.wrap_positions(torch.tensor(pos, dtype=torch.float64), tbox)
    jgrid = jcr.RollGrid.for_box(h, 4.5, CAP)
    tgrid = tcr.RollGrid.for_box(h, 4.5, CAP)
    jb = jcr.build_bins(jgrid, jpos, jnp.asarray(species), jbox)
    tb = tcr.build_bins(tgrid, tpos, torch.tensor(species), tbox)
    assert int(tb.count_max) <= CAP
    spec = taev.ani2x_aev_spec()
    out = dict(spec=spec, grid=tgrid, bins=tb)
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        p = tpos.to(dtype)
        pos_g, sp_g = tar._grid_inputs(tb.inv, p, tb.species_grid)
        out[name] = (pos_g, sp_g, tbox.h.to(dtype).contiguous(),
                     tgrid.ncells, spec)
    out["jax"] = {caps: tuple(np.asarray(x) for x in jap._angular_fwd_impl(
        jaev.ani2x_aev_spec(), jgrid, caps, PRESENT, True, jpos, jbox.h,
        jb.inv, jb.species_grid, jb.cell, jb.slot)) for caps in (CAPS, TRUNC)}
    return out


@pytest.fixture(scope="module")
def runs(grid_case):
    """Transcription and plain version per (dtype, caps)."""
    res = {}
    for name in ("f64", "f32"):
        for caps in (CAPS, TRUNC):
            args = (*grid_case[name], caps, PRESENT)
            res[name, caps] = dict(emulated=emulate_angular_fwd(*args),
                                   plain=tar.angular_fwd_plain(*args))
    return res


@pytest.mark.parametrize("seed", range(3))
def test_reduce_scatter32_gives_each_column_sum(seed):
    """f64: lane l ends with column l summed over the 32 lanes, to 1e-15 of
    the column's magnitude sum."""
    acc = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (32, 32)))
    got = reduce_scatter32(acc)
    scale = acc.abs().sum(0)
    assert bool(((got - acc.sum(0)).abs() <= 1e-15 * scale).all())


@pytest.mark.parametrize("caps", [CAPS, TRUNC], ids=["caps", "truncating"])
def test_compaction_keeps_the_backwards_slots(grid_case, caps):
    """The forward's compaction is the backward's: the slots hold the
    plain version's lanes (the first caps[s] in-Rca lanes of species s in
    ascending lane order) also where the caps truncate."""
    pos_g, sp_g, h, ncells, spec = grid_case["f64"]
    cst = tar.angular_consts(spec, pos_g.dtype)
    win_p, win_s = stage_window(pos_g, sp_g, h, ncells, PRESENT)
    lanes = compact(cst, caps, PRESENT, pos_g, win_p, win_s)[0]
    cp, cs = tar._candidates(ncells, pos_g, sp_g, h, 1)
    slots = tar._angular_slots(caps, PRESENT, pos_g, cp, cs, cst)[0]
    off = 0
    for s, c in enumerate(caps):
        if not c:
            continue
        ref = slots[s]["lane"]
        ref = torch.where(ref < cp.shape[1], ref, -1)
        assert torch.equal(lanes[..., off:off + c], ref)
        off += c


@pytest.mark.parametrize("caps", [CAPS, TRUNC], ids=["caps", "truncating"])
def test_f64_transcription_matches_plain(runs, caps):
    got, deficit, _ = runs["f64", caps]["emulated"]
    ref, ref_deficit = runs["f64", caps]["plain"]
    scale = float(ref.abs().max())
    assert scale > 1.0
    assert float((got - ref).abs().max()) <= 1e-12 * scale
    assert deficit == int(ref_deficit)
    if caps == TRUNC:
        assert deficit > 0
    else:
        assert deficit <= 0


@pytest.mark.parametrize("caps", [CAPS, TRUNC], ids=["caps", "truncating"])
def test_f64_transcription_matches_jax(grid_case, runs, caps):
    """The rows of the binned atoms, and the deficit, against the JAX
    kernel's."""
    got, deficit, _ = runs["f64", caps]["emulated"]
    b = grid_case["bins"]
    rows = got[b.cell, b.slot].numpy()
    out_j, deficit_j = grid_case["jax"][caps]
    assert np.abs(rows - out_j).max() <= 1e-10 * np.abs(out_j).max()
    assert deficit == int(deficit_j)


def test_every_entry_is_written(grid_case, runs):
    """Zeros in absent species-pair blocks and on rows with no atom: the
    output needs no zero fill."""
    got = runs["f64", CAPS]["emulated"][0]
    sp_g, spec = grid_case["f64"][1], grid_case["spec"]
    assert bool((sp_g < 0).any())
    assert not got[sp_g < 0].any()
    present = {ch0 for *_, ch0, _ in tar._pair_blocks(spec, CAPS)}
    absent = [b for b in range(spec.angular_length // 32)
              if 32 * b not in present]
    assert len(absent) == 25
    for b in absent:
        assert not got[..., 32 * b:32 * b + 32].any()


@pytest.mark.parametrize("trig_err", [0.0, HW_TRIG_ERR, -HW_TRIG_ERR])
@pytest.mark.parametrize("caps", [CAPS, TRUNC], ids=["caps", "truncating"])
def test_f32_transcription_within_the_gate(grid_case, runs, caps, trig_err):
    """f32: ex2 Gaussians, the split power, the hardware cosine at its
    worst-case error either way, against the plain f32 version within 0.25
    of the gate, and against the f64 plain version no worse than the plain
    f32 version is, plus 0.1 of the gate."""
    if trig_err:
        got, deficit, _ = emulate_angular_fwd(*grid_case["f32"], caps,
                                              PRESENT, trig_err=trig_err)
    else:
        got, deficit, _ = runs["f32", caps]["emulated"]
    want, want_deficit = runs["f32", caps]["plain"]
    assert deficit == int(want_deficit)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= 0.25 * gate(scale), (err, gate(scale))
    ref = runs["f64", caps]["plain"][0]
    lim = gate(float(ref.abs().max()))
    err64 = float((got.double() - ref).abs().max())
    err_plain = float((want.double() - ref).abs().max())
    assert err64 <= err_plain + 0.1 * lim, (err64, err_plain, lim)
