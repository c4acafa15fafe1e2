"""The arithmetic and order of the roll engine's radial_fwd kernel
(lammps_ani_torch/csrc/aev_roll.cu, `radial_fwd_kernel`), transcribed in
torch and held against the plain version and the JAX package's
`_radial_fwd_kernel` (through `_radial_fwd_impl`, interpret mode).
chip_smoke.py holds the kernel itself against the plain version on the
card.

The kernel takes one bin per block, writes zeros to every entry of its
rows, and stages the lanes of present species of its shell-s window,
compacted in lane order, `chunk` window lanes a pass (`kernel_chunk`: the
most that leave a full SM of 8-warp blocks resident). The bin's real
centers go one a warp; a warp tests the staged lanes 32 at a time and
packs the lanes within Rcr (self excluded) in lane order onto full groups
of 32 (the last group of a pass holds what is left). Each lane of a group
takes one pair: g_k = (0.125 cos(pi d / Rcr) + 0.125) exp(-eta (d - mu0 -
k delta)^2), k < 16, every species in the same pass. Per present species
with a pair in the group, the columns g_k of that species' pairs (0
elsewhere) go through a reduce-scatter of 16 columns over the 32 lanes
(four shuffle steps, then the two half-warps added), and lane k adds
column k to the center's row of the output, which runs on from pass to
pass. Columns of absent species and rows of empty slots keep their zeros.

In f32 the Gaussians are ex2(geta xk^2) (geta = -eta log2 e, ex2 taken
exactly here) and the cosine the hardware's (applied at its worst-case
error 2^-21.4).

System: WATER30 x 3^3 (810 atoms, 24 A box). Shell 2: the roll engine's
fine grid (bin side >= (Rcr + skin) / 2 = 3.55 A: 6 x 6 x 6 bins) at cap
12; shell 1: the pallas hybrid's grid (bin side >= Rcr + skin = 7.1 A: 3 x
3 x 3 bins) at cap 48. Limits: f64 against the plain version 1e-12 of the
largest magnitude; against JAX (shell 2, once per module) 1e-10; f32
within 0.25 of chip_smoke's gate (5e-6 + 1e-5 x the largest magnitude) of
the plain f32 version.
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

from .test_torch_neighbors import boxes, water_system
from .test_torch_roll_radial_bwd_order import staged_window

PRESENT = (0, 3)
GRIDS = {2: (3.55, 12), 1: (7.1, 48)}  # shell: (bin side, cap)
LOG2E = 1.4426950408889634
HW_TRIG_ERR = 2.0 ** -21.41  # __cosf on [-pi, pi] (CUDA guide)


def gate(scale):
    return 5e-6 + 1e-5 * scale


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduce_scatter16(v):
    """The kernel's four `reduce_step`s (widths 8, 4, 2, 1) on v [32 lanes,
    16 columns], then lane l's v[0] plus lane l ^ 16's: returns [32], lane
    l's result (column l & 15)."""
    lanes = torch.arange(32)
    for w in (8, 4, 2, 1):
        upper = (lanes & w) != 0
        new = v.clone()
        for i in range(w):
            send = torch.where(upper, v[:, i], v[:, i + w])
            keep = torch.where(upper, v[:, i + w], v[:, i])
            new[:, i] = keep + send[lanes ^ w]
        v = new
    return v[:, 0] + v[lanes ^ 16, 0]


def pair_columns(d, cst, trig_err):
    """[q, 16] columns g_k of q pairs at distances d."""
    rc, eta, mu0, delta, nr = cst
    dtype = d.dtype
    f32 = dtype == torch.float32

    def c(v):
        return torch.tensor(v, dtype=dtype)

    arg = d * c(math.pi / rc)
    cos = ((torch.cos(arg.double()) + trig_err).to(dtype) if f32
           else torch.cos(arg))
    pref = c(0.125) * cos + c(0.125)
    x = d - c(mu0)
    geta = c(-eta * LOG2E) if f32 else c(-eta)
    cols = []
    for k in range(16):
        xk = x - c(float(k)) * c(delta)
        y = geta * xk * xk
        e = torch.exp2(y.double()).to(dtype) if f32 else torch.exp(y)
        cols.append(pref * e if k < nr else torch.zeros_like(d))
    return torch.stack(cols, -1)


def kernel_chunk(cap, shell, dtype):
    """The window lanes the kernel stages a pass (its host's rule): the
    most that leave 28,160 B a block (eight 8-warp blocks an SM) beside
    the centers' slots int [cap] and 8 warps' packed lanes (int and T,
    64 each), at least 32, at most the window; a staged lane takes 16 B
    in f32, 32 in f64."""
    fsize = 4 if dtype == torch.float32 else 8
    fixed = -(-4 * cap // 16) * 16 + 8 * (256 + 64 * fsize)
    fit = max(0, 28160 - fixed) // (4 * fsize)
    return min((2 * shell + 1) ** 3 * cap, max(32, fit))


def emulate_radial_fwd(pos_g, sp_g, h, ncells, shell, spec, present,
                       chunk=None, nw=8, trig_err=0.0):
    """out [NC, cap, S NR] as the kernel computes it, staging `chunk`
    window lanes a pass (None: the kernel's), centers dealt to `nw` warps
    in rounds."""
    cst = tar.radial_consts(spec)
    rc, nr = cst[0], cst[4]
    dtype = pos_g.dtype
    nc, cap = sp_g.shape
    ns = 2 * shell + 1
    n_win = ns ** 3 * cap
    chunk = chunk or kernel_chunk(cap, shell, dtype)
    self_off = (ns ** 3 - 1) // 2
    win_p, win_s, _ = staged_window(pos_g, sp_g, h, ncells, shell, present)
    S = spec.num_species
    out = torch.zeros((nc, cap, S * nr), dtype=dtype)
    rc2_hi = float(torch.tensor(rc, dtype=dtype)) ** 2 * (1 + 2.0 ** -20)
    for cell in range(nc):
        ctr = [a for a in range(cap) if sp_g[cell, a] >= 0]
        # a center's row of the output: lane k of species s at [s, k]
        racc = {a: torch.zeros((S, 32), dtype=dtype) for a in ctr}
        for lo in range(0, n_win, chunk):
            hi = min(n_win, lo + chunk)
            lanes = torch.arange(lo, hi)
            kept = lanes[win_s[cell, lo:hi] >= 0]  # lane order
            # warp v takes centers v, v + nw, ...: rounds of nw
            for r0 in range(0, len(ctr), nw):
                for a in ctr[r0:r0 + nw]:
                    dvec = pos_g[cell, a] - win_p[cell, kept]
                    d2 = (dvec * dvec).sum(-1)
                    d = torch.sqrt(torch.clamp(d2, min=1e-12))
                    m = ((kept != self_off * cap + a) & (d2 <= rc2_hi)
                         & (d <= rc))
                    es = win_s[cell, kept[m]]
                    g = pair_columns(d[m], cst, trig_err)
                    for g0 in range(0, g.shape[0], 32):
                        gg, ee = g[g0:g0 + 32], es[g0:g0 + 32]
                        for s in present:
                            if not bool((ee == s).any()):
                                continue
                            v = torch.zeros((32, 16), dtype=dtype)
                            v[:gg.shape[0]] = torch.where(
                                (ee == s)[:, None], gg, 0.0)
                            racc[a][s] = racc[a][s] + reduce_scatter16(v)
        for a in ctr:
            for s in present:
                out[cell, a, s * nr:(s + 1) * nr] = racc[a][s][:nr]
    return out


@pytest.fixture(scope="module")
def case():
    species, pos, h, origin, _ = water_system(3)
    jbox, tbox = boxes(h, origin)
    tpos = tnb.wrap_positions(torch.tensor(pos, dtype=torch.float64), tbox)
    spec = taev.ani2x_aev_spec()
    out = dict(spec=spec)
    for shell, (side, cap) in GRIDS.items():
        grid = tcr.RollGrid.for_box(h, side, cap)
        bins = tcr.build_bins(grid, tpos, torch.tensor(species), tbox)
        assert int(bins.count_max) <= cap
        for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            pos_g, sp_g = tar._grid_inputs(bins.inv, tpos.to(dtype),
                                           bins.species_grid)
            args = (pos_g, sp_g, tbox.h.to(dtype).contiguous(), grid.ncells,
                    shell, spec, PRESENT)
            out[shell, name] = dict(args=args, bins=bins,
                                    emulated=emulate_radial_fwd(*args),
                                    plain=tar.radial_fwd_plain(*args))
    assert tuple(out[2, "f64"]["args"][3]) == (6, 6, 6)
    assert tuple(out[1, "f64"]["args"][3]) == (3, 3, 3)
    # the JAX kernel at shell 2, once
    jpos = jnb.wrap_positions(jnp.asarray(pos, jnp.float64), jbox)
    jgrid = jcr.RollGrid.for_box(h, *GRIDS[2])
    jb = jcr.build_bins(jgrid, jpos, jnp.asarray(species), jbox)
    out["jax"] = np.asarray(jap._radial_fwd_impl(
        jaev.ani2x_aev_spec(), jgrid, PRESENT, True, 2, jpos, jbox.h, jb.inv,
        jb.species_grid, jb.cell, jb.slot))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_reduce_scatter16_gives_each_column_sum(seed):
    """f64: lanes l and l + 16 end with column l summed over the 32 lanes,
    to 1e-15 of the column's magnitude sum."""
    v = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (32, 16)))
    got = reduce_scatter16(v)
    want = v.sum(0).repeat(2)
    assert bool(((got - want).abs() <= 1e-15 * v.abs().sum(0).repeat(2))
                .all())


@pytest.mark.parametrize("shell", [2, 1])
def test_f64_transcription_matches_plain(case, shell):
    got = case[shell, "f64"]["emulated"]
    ref = case[shell, "f64"]["plain"]
    scale = float(ref.abs().max())
    assert scale > 0.1
    assert float((got - ref).abs().max()) <= 1e-12 * scale


def test_f64_transcription_matches_jax(case):
    """The rows of the binned atoms at shell 2 against the JAX kernel's."""
    got = case[2, "f64"]["emulated"]
    b = case[2, "f64"]["bins"]
    rows = got[b.cell, b.slot].numpy()
    ref = case["jax"]
    assert rows.shape == ref.shape
    assert np.abs(rows - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("shell", [2, 1])
def test_every_entry_is_written(case, shell):
    """Zeros in the columns of absent species and on rows with no atom:
    the output needs no zero fill; the present columns of real rows are
    not all zero."""
    got = case[shell, "f64"]["emulated"]
    sp_g, spec = case[shell, "f64"]["args"][1], case["spec"]
    nr = tar.radial_consts(spec)[4]
    assert bool((sp_g < 0).any())
    assert not got[sp_g < 0].any()
    for s in range(spec.num_species):
        cols = got[..., s * nr:(s + 1) * nr]
        if s in PRESENT:
            assert bool(cols[sp_g >= 0].any())
        else:
            assert not cols.any()


def test_kernel_chunk_at_the_test_caps():
    """The host's pass sizes at this file's grids: f32 stages the whole
    window, f64 three passes at shell 2 and two at shell 1; at cap 256 and
    shell 2 a pass still holds hundreds of lanes in both dtypes."""
    assert kernel_chunk(12, 2, torch.float32) == 125 * 12
    assert kernel_chunk(48, 1, torch.float32) == 27 * 48
    assert kernel_chunk(12, 2, torch.float64) == 686
    assert kernel_chunk(48, 1, torch.float64) == 682
    assert kernel_chunk(32, 2, torch.float32) == 1496
    assert kernel_chunk(256, 2, torch.float64) == 656
    assert kernel_chunk(256, 2, torch.float32) == 1440


@pytest.mark.parametrize("nw,chunk", [(1, None), (3, None), (5, 100),
                                      (8, 125 * 12)])
def test_result_does_not_depend_on_warps_or_staging(case, nw, chunk):
    """Shell 2, f64: the same bits at any warp count, at another pass size
    within 1e-13 (a pass ends a group early), and each within 1e-12 of the
    plain version."""
    args = case[2, "f64"]["args"]
    base = case[2, "f64"]["emulated"]
    got = emulate_radial_fwd(*args, chunk=chunk, nw=nw)
    if chunk is None:
        assert torch.equal(got.view(torch.int64), base.view(torch.int64))
    else:
        scale = float(base.abs().max())
        assert float((got - base).abs().max()) <= 1e-13 * scale
        ref = case[2, "f64"]["plain"]
        assert float((got - ref).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("trig_err", [0.0, HW_TRIG_ERR, -HW_TRIG_ERR])
@pytest.mark.parametrize("shell", [2, 1])
def test_f32_transcription_within_the_gate(case, shell, trig_err):
    """f32: ex2 Gaussians and the hardware cosine at its worst-case error
    either way, against the plain f32 version within 0.25 of the gate."""
    args = case[shell, "f32"]["args"]
    got = (emulate_radial_fwd(*args, trig_err=trig_err) if trig_err
           else case[shell, "f32"]["emulated"])
    want = case[shell, "f32"]["plain"]
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= 0.25 * gate(scale), (err, gate(scale))
