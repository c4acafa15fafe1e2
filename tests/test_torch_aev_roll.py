"""The plain versions of the four roll-grid AEV kernels vs the JAX
functions that reach the Pallas kernels (interpret mode), f64.

System: WATER30 replicated 2x2x2 (240 atoms, 16 A box), a 3x3x3 fine
grid (bin side >= 4.5 A) at cap 16; radial window shell 2; angular caps
H 20, O 12. The JAX outputs are computed once per module.

Tolerances (as tests/test_aev_pallas.py): AEV atol 1e-10 rtol 1e-8;
dpos atol 1e-9; dh atol 1e-8.
"""

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

PRESENT = (0, 3)
CAPS = (20, 0, 0, 12, 0, 0, 0)
SHELL = 2

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: with several test processes on one machine, each
    with a thread per core, the threads wait on one another at every
    operation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def roll_case(dtype, seed=0):
    """Port inputs, and JAX reference outputs of the four *_impl
    functions (radial fwd/bwd at shell 2, angular fwd/bwd)."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    species, pos, h, origin, _ = water_system(2)
    jbox, tbox = boxes(h, origin)
    jbox = jnb.Box(h=jbox.h.astype(jdt), origin=jbox.origin.astype(jdt))
    tbox = tbox.to(dtype=dtype)
    jpos = jnb.wrap_positions(jnp.asarray(pos, jdt), jbox)
    tpos = tnb.wrap_positions(torch.tensor(pos, dtype=dtype), tbox)
    jgrid = jcr.RollGrid.for_box(h, 4.5, 16)
    tgrid = tcr.RollGrid.for_box(h, 4.5, 16)
    jb = jcr.build_bins(jgrid, jpos, jnp.asarray(species), jbox)
    tb = tcr.build_bins(tgrid, tpos, torch.tensor(species), tbox)
    assert int(tb.count_max) <= tgrid.cap
    rng = np.random.default_rng(seed)
    n = len(species)
    ga_r = rng.standard_normal((n, 112))
    ga_a = rng.standard_normal((n, 896))
    spec = jaev.ani2x_aev_spec()
    jargs = (jpos, jbox.h, jb.inv, jb.species_grid, jb.cell, jb.slot)
    ref = {}
    ref["radial"] = np.asarray(jap._radial_fwd_impl(
        spec, jgrid, PRESENT, True, SHELL, *jargs))
    dp, dh = jap._radial_bwd_impl(spec, jgrid, PRESENT, True, SHELL, *jargs,
                                  jnp.asarray(ga_r, jdt))
    ref["radial_dpos"], ref["radial_dh"] = np.asarray(dp), np.asarray(dh)
    out, deficit = jap._angular_fwd_impl(spec, jgrid, CAPS, PRESENT, True,
                                         *jargs)
    ref["angular"], ref["deficit"] = np.asarray(out), float(deficit)
    dp, dh = jap._angular_bwd_impl(spec, jgrid, CAPS, PRESENT, True, *jargs,
                                   jnp.asarray(ga_a, jdt))
    ref["angular_dpos"], ref["angular_dh"] = np.asarray(dp), np.asarray(dh)
    port = dict(spec=taev.ani2x_aev_spec(), grid=tgrid, bins=tb, pos=tpos,
                box=tbox, species=species,
                args=(tpos, tbox.h, tb.inv, tb.species_grid, tb.cell,
                      tb.slot),
                ga_r=torch.tensor(ga_r, dtype=dtype),
                ga_a=torch.tensor(ga_a, dtype=dtype))
    return port, ref


def port_outputs(port):
    spec, grid, args = port["spec"], port["grid"], port["args"]
    got = {}
    got["radial"] = tar._radial_fwd_impl(spec, grid, PRESENT, SHELL, *args)
    got["radial_dpos"], got["radial_dh"] = tar._radial_bwd_impl(
        spec, grid, PRESENT, SHELL, *args, port["ga_r"])
    got["angular"], got["deficit"] = tar._angular_fwd_impl(
        spec, grid, CAPS, PRESENT, *args)
    got["angular_dpos"], got["angular_dh"] = tar._angular_bwd_impl(
        spec, grid, CAPS, PRESENT, *args, port["ga_a"])
    return {k: (float(v) if k == "deficit" else v.numpy())
            for k, v in got.items()}


@pytest.fixture(scope="module")
def case64():
    port, ref = roll_case(torch.float64)
    return port, ref, port_outputs(port)


TOL64 = {"radial": dict(atol=1e-10, rtol=1e-8),
         "angular": dict(atol=1e-10, rtol=1e-8),
         "radial_dpos": dict(atol=1e-9, rtol=0),
         "angular_dpos": dict(atol=1e-9, rtol=0),
         "radial_dh": dict(atol=1e-8, rtol=0),
         "angular_dh": dict(atol=1e-8, rtol=0)}


@pytest.mark.parametrize("quantity", sorted(TOL64))
def test_plain_matches_jax_f64(case64, quantity):
    _, ref, got = case64
    assert got[quantity].shape == ref[quantity].shape
    assert np.abs(ref[quantity]).max() > 0
    np.testing.assert_allclose(got[quantity], ref[quantity],
                               **TOL64[quantity])


def test_angular_deficit_matches_jax(case64):
    _, ref, got = case64
    assert got["deficit"] == ref["deficit"] <= 0


def _energy_grads(port, fn, w):
    """dE/dpos, dE/dh of E = sum(fn(pos, box) @ w)."""
    pos = port["pos"].clone().requires_grad_(True)
    h = port["box"].h.clone().requires_grad_(True)
    box = tnb.Box(h=h, origin=port["box"].origin)
    e = torch.sum(fn(pos, box) @ w)
    return torch.autograd.grad(e, (pos, h))


@pytest.mark.parametrize("channel", ["radial", "angular"])
def test_autograd_function_matches_plain_autograd(case64, channel):
    """The kernels' backward (autograd.Function) against torch.autograd
    through the plain forward, f64."""
    port = case64[0]
    spec, grid, bins = port["spec"], port["grid"], port["bins"]
    w = torch.tensor(np.random.default_rng(4).standard_normal(
        spec.radial_length if channel == "radial" else spec.angular_length))

    def plain(pos, box):
        pos_g = tar._to_grid_rows(bins.inv, pos, 1e6)
        sp_g = bins.species_grid
        if channel == "radial":
            out = tar.radial_fwd_plain(pos_g, sp_g, box.h, grid.ncells,
                                       SHELL, spec, PRESENT)
        else:
            out, _ = tar.angular_fwd_plain(pos_g, sp_g, box.h, grid.ncells,
                                           spec, CAPS, PRESENT)
        return out[bins.cell, bins.slot]

    def function(pos, box):
        if channel == "radial":
            return tar.radial_aev_roll(spec, grid, bins, pos, box,
                                       species_counts=(160, 0, 0, 80, 0, 0, 0),
                                       shell=SHELL)
        return tar.angular_aev_roll(spec, grid, bins, pos, box, CAPS)[0]

    g_fn, gh_fn = _energy_grads(port, function, w)
    g_pl, gh_pl = _energy_grads(port, plain, w)
    np.testing.assert_allclose(g_fn.numpy(), g_pl.numpy(), atol=1e-9)
    np.testing.assert_allclose(gh_fn.numpy(), gh_pl.numpy(), atol=1e-8)


def test_tight_caps_report_deficit(case64):
    """Caps of 1 per present species truncate: the deficit is the worst
    per-species degree within Rca minus 1 (degrees from the brute
    neighbor matrix)."""
    port = case64[0]
    spec = port["spec"]
    tight = tuple(1 if c else 0 for c in CAPS)
    _, deficit = tar._angular_fwd_impl(spec, port["grid"], tight, PRESENT,
                                       *port["args"])
    pos, box = port["pos"], port["box"]
    ghosts = tnb.build_ghosts(pos, box, 3.5, 4096, tnb.image_shifts(1))
    nl = tnb.build_neighbor_matrix_brute(pos, box, 3.5, 64, ghosts)
    sj = tnb.extended_species(torch.tensor(port["species"]), ghosts)[nl.idx]
    worst = max(int(((sj == s) & nl.mask).sum(1).max()) for s in PRESENT)
    assert float(deficit) == worst - 1 > 0


def test_plain_row_chunks_agree(case64, monkeypatch):
    """The plain versions cut the grid into row chunks to bound memory at
    large grids: a cut every few bins gives the same outputs."""
    monkeypatch.setattr(tar, "PLAIN_CHUNK_ELEMS", 5 * 16 * 2000)
    port, _, whole = case64
    assert len(tar._row_chunks(27, 16, 2000)) == 6
    chunked = port_outputs(port)
    for k, v in whole.items():
        np.testing.assert_allclose(chunked[k], v, rtol=1e-13, atol=1e-13)


def test_radial_species_pruning_is_exact(case64):
    port = case64[0]
    full = tar._radial_fwd_impl(port["spec"], port["grid"], tuple(range(7)),
                                SHELL, *port["args"])
    np.testing.assert_array_equal(full.numpy(), case64[2]["radial"])


def test_wrappers_count_plain_calls_and_refuse_other_devices(case64):
    port = case64[0]
    tar.reset_counts()
    port_outputs(port)
    assert tar.PLAIN_CALLS == dict.fromkeys(tar.PLAIN_CALLS, 1)
    assert tar.LAUNCHES == dict.fromkeys(tar.LAUNCHES, 0)
    meta = torch.empty((27, 16, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="devices"):
        tar.radial_fwd(meta, port["bins"].species_grid, port["box"].h,
                       (3, 3, 3), SHELL, port["spec"], PRESENT)
