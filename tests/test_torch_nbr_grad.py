"""The port's mirror tables and mirror-backward displacement ops
(lammps_ani_torch.ops.nbr_grad) vs the JAX package's.

WATER30 replicated 3x3x3 (810 atoms, 24 A box), lightly jittered, f64.
Both sides resolve the same neighbor matrix (the JAX package's brute
build at Rcr + skin = 7.1 A, handed to the port as numpy arrays), so every
table must be identical: owners, shifts, mirror slots, masks, the angular
sub-list (radius Rca + ang_skin = 4.5 A), its tables and the ok flag. The
forwards and backwards of `neighbor_diff` and `neighbor_dist`, the box
cotangent included, agree with `jax.vjp` to 1e-12 of the largest entry
(f64 sums taken in another order), and with plain autograd through a
gather to the same limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ani_tpu.ops import nbr_grad as jng
from lammps_ani_tpu.ops import neighbors as jnb
from lammps_ani_torch.ops import nbr_grad as tng
from lammps_ani_torch.ops import neighbors as tnb

from .test_torch_neighbors import water_system

RLIST = 7.1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's plain path is a chain of tensor operations; with several
    test processes on one machine, each with a thread per core, the
    threads wait on one another at every operation. One thread keeps this
    file's time flat."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
ANG_CUT = 4.5
K_MAX = 128
TOL = 1e-12


def _port_nlist(jnl):
    """The JAX neighbor matrix as the port's NeighborList."""
    g = jnl.ghosts
    t = lambda x: torch.tensor(np.asarray(x))
    ghosts = tnb.Ghosts(src=t(g.src).long(), shift=t(g.shift).long(),
                        mask=t(g.mask), count=t(g.count).long())
    return tnb.NeighborList(idx=t(jnl.idx).long(), mask=t(jnl.mask),
                            ghosts=ghosts, max_count=t(jnl.max_count).long())


@pytest.fixture(scope="module")
def system():
    species, pos, h, origin, _ = water_system(3, jitter=0.05, seed=2)
    jbox = jnb.Box(h=jnp.asarray(h), origin=jnp.asarray(origin))
    tbox = tnb.Box(h=torch.tensor(h), origin=torch.tensor(origin))
    jpos = jnb.wrap_positions(jnp.asarray(pos), jbox)
    tpos = torch.tensor(np.asarray(jpos))
    ghosts = jnb.build_ghosts(jpos, jbox, RLIST, 8192, jnb.image_shifts(1))
    jnl = jnb.build_neighbor_matrix_brute(jpos, jbox, RLIST, K_MAX, ghosts)
    assert int(jnl.max_count) <= K_MAX and int(ghosts.count) <= 8192
    return dict(n=len(species), jspecies=jnp.asarray(species),
                tspecies=torch.as_tensor(species).long(), jbox=jbox,
                tbox=tbox, jpos=jpos, tpos=tpos, jnl=jnl,
                tnl=_port_nlist(jnl))


def _tables(s, ang_cap=64, main_mirror=True, nl=None):
    jnl = s["jnl"] if nl is None else nl
    tnl = _port_nlist(jnl)
    jm = jng.mirror_neighbors(jnl, s["n"], pos=s["jpos"], box=s["jbox"],
                              ang_cutoff=ANG_CUT, ang_cap=ang_cap,
                              species=s["jspecies"], main_mirror=main_mirror)
    tm = tng.mirror_neighbors(tnl, s["n"], pos=s["tpos"], box=s["tbox"],
                              ang_cutoff=ANG_CUT, ang_cap=ang_cap,
                              species=s["tspecies"], main_mirror=main_mirror)
    return jm, tm


FIELDS = ("src", "shift", "mirror", "mask", "ok", "species_j", "ang_src",
          "ang_shift", "ang_mirror", "ang_mask", "ang_species",
          "ang_count_max")


@pytest.mark.parametrize("main_mirror", [True, False])
def test_mirror_tables_identical(system, main_mirror):
    jm, tm = _tables(system, main_mirror=main_mirror)
    assert bool(tm.ok)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)


@pytest.mark.parametrize("case", ["ang_cap", "k_max"])
def test_mirror_ok_flag_matches_on_truncation(system, case):
    """A sub-list over its cap, or a truncated neighbor matrix (slots
    whose mirror was cut off), clears `ok` on both sides; the tables stay
    identical."""
    s = system
    if case == "ang_cap":
        jm, tm = _tables(s, ang_cap=16)
    else:
        ghosts = s["jnl"].ghosts
        jnl = jnb.build_neighbor_matrix_brute(s["jpos"], s["jbox"], RLIST,
                                              64, ghosts)
        jm, tm = _tables(s, nl=jnl)
    assert not bool(jm.ok) and not bool(tm.ok)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)


def test_shift_code_and_owners(system):
    sh = np.array(np.meshgrid(*[[-1, 0, 1]] * 3, indexing="ij")).reshape(
        3, -1).T
    np.testing.assert_array_equal(
        tng.shift_code(torch.as_tensor(sh)).numpy(),
        np.asarray(jng.shift_code(jnp.asarray(sh))))
    src, shift = tng.resolve_owners(system["tnl"], system["n"])
    jsrc, jshift = jng.resolve_owners(system["jnl"], system["n"])
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(shift.numpy(), np.asarray(jshift))


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL * max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def ops(system):
    jm, tm = _tables(system)
    rng = np.random.default_rng(7)
    return dict(jm=jm, tm=tm, rng=rng)


@pytest.mark.parametrize("name,channel", [("neighbor_diff", "main"),
                                          ("neighbor_diff", "ang"),
                                          ("neighbor_dist", "main"),
                                          ("neighbor_dist", "ang")])
def test_op_forward_backward_matches_jax_vjp(system, ops, name, channel):
    """Forward, dpos and the box cotangent dh against jax.vjp of the JAX
    custom-VJP op, for a seeded cotangent."""
    s, jm, tm = system, ops["jm"], ops["tm"]
    pre = "ang_" if channel == "ang" else ""
    jargs = [getattr(jm, pre + f) for f in ("src", "shift", "mirror",
                                            "mask")]
    targs = [getattr(tm, pre + f) for f in ("src", "shift", "mirror",
                                            "mask")]
    jargs[1] = jargs[1].astype(jnp.float64)
    targs[1] = targs[1].to(torch.float64)
    jfn, tfn = getattr(jng, name), getattr(tng, name)
    out, vjp = jax.vjp(lambda p, h: jfn(p, h, *jargs), s["jpos"],
                       s["jbox"].h)
    g = ops["rng"].standard_normal(out.shape)
    jdpos, jdh = vjp(jnp.asarray(g))
    pos = s["tpos"].clone().requires_grad_(True)
    h = s["tbox"].h.clone().requires_grad_(True)
    got = tfn(pos, h, *targs)
    dpos, dh = torch.autograd.grad(got, (pos, h), torch.as_tensor(g))
    mask = np.asarray(jargs[3])
    sel = mask[..., None] if name == "neighbor_diff" else mask
    _close(np.where(sel, got.detach().numpy(), 0),
           np.where(sel, np.asarray(out), 0))
    np.testing.assert_array_equal(got.detach().numpy()[~mask],
                                  np.asarray(out)[~mask])
    _close(dpos.numpy(), jdpos)
    _close(dh.numpy(), jdh)


@pytest.mark.parametrize("name", ["neighbor_diff", "neighbor_dist"])
def test_mirror_backward_equals_plain_autograd(system, ops, name):
    """The mirror gather gives what plain autograd's scatter gives through
    pos[src] + shift @ h."""
    tm = ops["tm"]
    g = torch.as_tensor(ops["rng"].standard_normal(tm.mask.shape
                        + ((3,) if name == "neighbor_diff" else ())))
    shift_f = tm.shift.to(torch.float64)

    def plain(p, h):
        diff = p[:, None, :] - (p[tm.src] + shift_f @ h)
        diff = torch.where(tm.mask[..., None], diff, 1.0)
        if name == "neighbor_diff":
            return diff
        return torch.where(tm.mask, torch.linalg.norm(diff, dim=-1), 1e6)

    grads = []
    for fn in (lambda p, h: getattr(tng, name)(p, h, tm.src, shift_f,
                                               tm.mirror, tm.mask), plain):
        pos = system["tpos"].clone().requires_grad_(True)
        h = system["tbox"].h.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(pos, h), (pos, h), g))
    for got, ref in zip(*grads):
        _close(got.numpy(), ref.numpy())


def test_neighbor_displacements_mirror_matches_jax(system, ops):
    s, jm, tm = system, ops["jm"], ops["tm"]
    jd, jr = jng.neighbor_displacements_mirror(
        s["jpos"], s["jbox"], jm.ang_src, jm.ang_shift, jm.ang_mirror,
        jm.ang_mask)
    td, tr = tng.neighbor_displacements_mirror(
        s["tpos"], s["tbox"], tm.ang_src, tm.ang_shift, tm.ang_mirror,
        tm.ang_mask)
    _close(td.numpy(), jd)
    _close(np.minimum(tr.numpy(), 100.0), np.minimum(np.asarray(jr), 100.0))
    np.testing.assert_array_equal(tr.numpy() == 1e6, np.asarray(jr) == 1e6)


def test_subset_nlist_matches_jax(system):
    s = system
    jsub, jcnt = jng._subset_nlist(s["jnl"], s["jpos"], s["jbox"], s["n"],
                                   ANG_CUT, 40)
    tsub, tcnt = tng._subset_nlist(s["tnl"], s["tpos"], s["tbox"], s["n"],
                                   ANG_CUT, 40)
    assert int(tcnt) == int(jcnt)
    np.testing.assert_array_equal(tsub.idx.numpy(), np.asarray(jsub.idx))
    np.testing.assert_array_equal(tsub.mask.numpy(), np.asarray(jsub.mask))


def _boundary_pair(cutoff):
    """Two atoms across the x boundary of a 100 A f32 box, 'cutoff' apart
    to within f32 rounding: the JAX package's form pos_i - (pos_j + S h)
    keeps the pair on one side only (found by a seeded search)."""
    rng = np.random.default_rng(0)
    f = np.float32
    L, rc = f(100.0), f(cutoff)
    while True:
        a = f(rng.uniform(95.0, 99.99))
        b = f(a + rc - L + f(rng.uniform(-2e-5, 2e-5)))
        if not 0 < b < cutoff - 0.1:
            continue
        da, db = f(a - f(b + L)), f(b - f(a - L))
        if (f(da * da) < rc * rc) != (f(db * db) < rc * rc):
            return np.array([[a, 50.0, 50.0], [b, 50.0, 50.0]], np.float32)


@pytest.mark.parametrize("cutoff,use_cells", [(7.1, False), (7.1, True),
                                              (4.5, False)])
def test_f32_boundary_pair_is_selected_on_both_sides(cutoff, use_cells):
    """A pair at the cutoff within f32 rounding: the JAX tables lose its
    mirror (`ok` False, so the JAX engine regrows until it gives up); the
    port selects it on both rows or on neither, and its tables hold.
    cutoff 4.5: the angular sub-list's test (`_subset_nlist`), inside a
    7.1 A matrix."""
    from lammps_ani_tpu.ops import cell_list as jcl
    from lammps_ani_torch.ops import cell_list as tcl

    pos = _boundary_pair(cutoff)
    h, origin = np.eye(3, dtype=np.float32) * 100.0, np.zeros(3, np.float32)
    jbox = jnb.Box(h=jnp.asarray(h), origin=jnp.asarray(origin))
    tbox = tnb.Box(h=torch.tensor(h), origin=torch.tensor(origin))
    shifts = jnb.image_shifts(1)
    jg = jnb.build_ghosts(jnp.asarray(pos), jbox, 7.1, 64, shifts)
    tg = tnb.build_ghosts(torch.tensor(pos), tbox, 7.1, 64, shifts)
    if use_cells:
        jgrid = jcl.CellGrid.for_box(h, 7.1, 8)
        jnl = jcl.build_neighbor_matrix_cells(jnp.asarray(pos), jbox, 7.1,
                                              8, jg, grid=jgrid)
        tnl = tcl.build_neighbor_matrix_cells(
            torch.tensor(pos), tbox, 7.1, 8, tg,
            grid=tcl.CellGrid.for_box(h, 7.1, 8))
    else:
        jnl = jnb.build_neighbor_matrix_brute(jnp.asarray(pos), jbox, 7.1, 8,
                                              jg)
        tnl = tnb.build_neighbor_matrix_brute(torch.tensor(pos), tbox, 7.1,
                                              8, tg)
    kw = dict(ang_cutoff=4.5, ang_cap=8) if cutoff == 4.5 else {}
    jm = jng.mirror_neighbors(jnl, 2, pos=jnp.asarray(pos), box=jbox, **kw)
    tm = tng.mirror_neighbors(tnl, 2, pos=torch.tensor(pos), box=tbox, **kw)
    assert not bool(jm.ok) and bool(tm.ok)
    mask = tm.ang_mask if cutoff == 4.5 else tm.mask
    assert int(mask[0].sum()) == int(mask[1].sum())
