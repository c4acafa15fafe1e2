"""The port's mirror engine and its cell-roll hybrids vs the JAX package.

Potential level: WATER30 replicated 3x3x3 (810 atoms, 24 A box), lightly
jittered, species-sorted, f64. Both sides evaluate the same neighbor
matrix (the JAX package's brute build at 7.1 A, handed to the port) and
each builds its own mirror tables from it (tests/test_torch_nbr_grad.py
shows them identical). `compute_aev` (generic and species-blocked, with
a separate angular sub-list and a given radial block) agrees to 1e-12 of
the largest entry; `energy_forces_virial_mirror` with and without the
repulsion term, and with the `xla` and `pallas` hybrids (the roll grid's
radial channel: plain PyTorch, and the radial kernels' plain versions
against the JAX kernels in interpret mode), to pe rtol 1e-11, forces
1e-10 and virial 1e-9 of the largest entry (f64 sums in another order).

Engine level: `Simulation` with its default arguments (the mirror
engine; f64 on the CPU) against the JAX `Simulation` with its own, NVE,
explicit velocities: positions within 1e-10 A, on WATER30 x 2^3 (240
atoms) and on the 8 A tile itself (30 atoms), which no roll grid fits.
Each regrow kind (ghost, k_max, angular, mirror), forced by an undersized
capacity, grows the capacities the JAX engine grows and ends at its
positions (1e-10 A).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lammps_ani_tpu as jlat
import lammps_ani_torch as tlat
from lammps_ani_tpu.models import aev as jaev
from lammps_ani_tpu.models import potential as jpotmod
from lammps_ani_tpu.models import zoo as jzoo
from lammps_ani_tpu.ops import cell_roll as jcr
from lammps_ani_tpu.ops import nbr_grad as jng
from lammps_ani_tpu.ops import neighbors as jnb
from lammps_ani_torch.models import aev as taev
from lammps_ani_torch.models import potential as tpotmod
from lammps_ani_torch.models import zoo as tzoo
from lammps_ani_torch.ops import cell_roll as tcr
from lammps_ani_torch.ops import nbr_grad as tng
from lammps_ani_torch.ops import neighbors as tnb

from .test_torch_nbr_grad import _port_nlist
from .test_torch_neighbors import water_system

CAPS = (20, 0, 0, 12, 0, 0, 0)


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


def _pots(repulsion, caps=CAPS):
    jpot = jzoo.ani2x(num_models=1, dtype=jnp.float64, repulsion=repulsion)
    tpot = tzoo.ani2x(num_models=1, dtype=torch.float64, device="cpu",
                      repulsion=repulsion, params=tzoo.params_from_numpy(
                          jax.tree.map(np.asarray, jpot.params)))
    if caps is not None:
        jpot = jpotmod.ANIPotential(
            spec=dataclasses.replace(jpot.spec, angular_caps=caps),
            params=jpot.params)
        tpot = tpot.with_spec(dataclasses.replace(tpot.spec,
                                                  angular_caps=caps))
    return jpot, tpot


@pytest.fixture(scope="module")
def sys810():
    species, pos, h, origin, _ = water_system(3, jitter=0.05, seed=4)
    order = np.argsort(species, kind="stable")
    species, pos = species[order], pos[order]
    n = len(species)
    jbox = jnb.Box(h=jnp.asarray(h), origin=jnp.asarray(origin))
    tbox = tnb.Box(h=torch.tensor(h), origin=torch.tensor(origin))
    jpos = jnb.wrap_positions(jnp.asarray(pos), jbox)
    tpos = torch.tensor(np.asarray(jpos))
    ghosts = jnb.build_ghosts(jpos, jbox, 7.1, 8192, jnb.image_shifts(1))
    jnl = jnb.build_neighbor_matrix_brute(jpos, jbox, 7.1, 128, ghosts)
    tnl = _port_nlist(jnl)
    jsp, tsp = jnp.asarray(species), torch.as_tensor(species).long()
    tables = {}
    for main in (True, False):
        tables[main] = (
            jng.mirror_neighbors(jnl, n, pos=jpos, box=jbox, ang_cutoff=4.5,
                                 ang_cap=64, species=jsp, main_mirror=main),
            tng.mirror_neighbors(tnl, n, pos=tpos, box=tbox, ang_cutoff=4.5,
                                 ang_cap=64, species=tsp, main_mirror=main))
        assert bool(tables[main][0].ok) and bool(tables[main][1].ok)
    grid = jcr.RollGrid.for_box(h, 6.1, 64)
    cap = -(-int(jcr.build_bins(grid, jpos, jsp, jbox).count_max) // 4) * 4
    jgrid = jcr.RollGrid(ncells=grid.ncells, cap=cap)
    tgrid = tcr.RollGrid(ncells=grid.ncells, cap=cap)
    return dict(n=n, species=species, jsp=jsp, tsp=tsp, jbox=jbox,
                tbox=tbox, jpos=jpos, tpos=tpos, jnl=jnl, tnl=tnl,
                tables=tables, jgrid=jgrid, tgrid=tgrid,
                jbins=jcr.build_bins(jgrid, jpos, jsp, jbox),
                tbins=tcr.build_bins(tgrid, tpos, tsp, tbox),
                counts=tuple(int((species == s).sum()) for s in range(7)))


def _close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def test_caps_hold_every_neighbor(sys810):
    s = sys810
    _, dist = jnb.neighbor_displacements(s["jpos"], s["jbox"], s["jnl"])
    sj = jnb.extended_species(s["jsp"], s["jnl"].ghosts)[s["jnl"].idx]
    ref = jaev.angular_cap_deficit(jaev.ani2x_aev_spec(), dist, sj,
                                   s["jnl"].mask & (sj >= 0), CAPS)
    _, tdist = tnb.neighbor_displacements(s["tpos"], s["tbox"], s["tnl"])
    tsj = tnb.extended_species(s["tsp"], s["tnl"].ghosts)[s["tnl"].idx]
    got = taev.angular_cap_deficit(taev.ani2x_aev_spec(), tdist, tsj,
                                   s["tnl"].mask & (tsj >= 0), CAPS)
    assert int(got) == int(ref) <= 0


@pytest.mark.parametrize("path", ["generic", "blocked"])
@pytest.mark.parametrize("inputs", ["matrix", "sublist_and_radial"])
def test_compute_aev_matches_jax(sys810, path, inputs):
    """Forward, and the gradient of a seeded projection w.r.t. every
    differentiable input, to 1e-12 of the largest entry."""
    s = sys810
    jm, tm = s["tables"][True]
    spec_j, spec_t = jaev.ani2x_aev_spec(), taev.ani2x_aev_spec()
    jdiff, jdist = jng.neighbor_displacements_mirror(
        s["jpos"], s["jbox"], jm.src, jm.shift, jm.mirror, jm.mask)
    jad, jar = jng.neighbor_displacements_mirror(
        s["jpos"], s["jbox"], jm.ang_src, jm.ang_shift, jm.ang_mirror,
        jm.ang_mask)
    rng = np.random.default_rng(11)
    rad = rng.standard_normal((s["n"], spec_j.radial_length))
    proj = rng.standard_normal((s["n"], spec_j.aev_length))
    kw = dict(angular_caps=CAPS if path == "blocked" else None,
              angular_capacity=40, atom_chunk=256)
    sub = inputs == "sublist_and_radial"

    def jfn(diff, dist, ad, ar, r):
        a_in = (ad, ar, jm.ang_species, jm.ang_mask) if sub else None
        aev = jaev.compute_aev(spec_j, s["jsp"], diff, dist, jm.species_j,
                               jm.mask, angular_inputs=a_in,
                               radial_override=r if sub else None, **kw)
        return aev, jnp.sum(aev * proj)

    jargs = (jdiff, jdist, jad, jar, jnp.asarray(rad))
    jaev_out, _ = jfn(*jargs)
    jgrads = jax.grad(lambda *a: jfn(*a)[1], argnums=(0, 1, 2, 3, 4))(*jargs)
    targs = [torch.tensor(np.asarray(x)).requires_grad_(True) for x in jargs]
    a_in = ((targs[2], targs[3], tm.ang_species, tm.ang_mask) if sub
            else None)
    aev = taev.compute_aev(spec_t, s["tsp"], targs[0], targs[1], tm.species_j,
                           tm.mask, angular_inputs=a_in,
                           radial_override=targs[4] if sub else None, **kw)
    _close(aev.detach(), jaev_out, 1e-12)
    grads = torch.autograd.grad((aev * torch.tensor(proj)).sum(), targs,
                                allow_unused=True)
    for g, jg in zip(grads, jgrads):
        if np.abs(np.asarray(jg)).max() == 0:
            assert g is None or float(g.abs().max()) == 0
        else:
            _close(g, jg, 1e-12)


EFV_CASES = {"mirror_repulsion": (True, None), "mirror": (False, None),
             "xla": (False, "xla"), "pallas": (False, "pallas")}


@pytest.mark.parametrize("case", list(EFV_CASES))
def test_energy_forces_virial_mirror_matches_jax(sys810, case):
    s = sys810
    repulsion, impl = EFV_CASES[case]
    jpot, tpot = _pots(repulsion)
    jm, tm = s["tables"][impl is None]
    troll = None if impl is None else (s["tgrid"], s["tbins"], impl)
    je, jf, jw = jax.jit(lambda pot, pos, box, nbrs, bins: (
        jpotmod.energy_forces_virial_mirror(
            pot, s["jsp"], pos, box, nbrs, species_counts=s["counts"],
            cellroll=None if impl is None else (s["jgrid"], bins, impl))))(
        jpot, s["jpos"], s["jbox"], jm, s["jbins"])
    te, tf, tw = tpotmod.energy_forces_virial_mirror(
        tpot, s["tsp"], s["tpos"], s["tbox"], tm,
        species_counts=s["counts"], cellroll=troll)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-11)
    _close(tf, jf, 1e-10)
    _close(tw, jw, 1e-9)


def test_plain_matrix_energy_forces_virial_matches_mirror(sys810):
    """`energy_forces_virial` over the plain neighbor matrix (autograd
    through the images) against the mirror path on the same matrix, and
    `energy_forces` against it."""
    s = sys810
    _, tpot = _pots(True)
    e0, f0, w0 = tpotmod.energy_forces_virial(
        tpot, s["tsp"], s["tpos"], s["tbox"], s["tnl"], s["counts"])
    e1, f1, w1 = tpotmod.energy_forces_virial_mirror(
        tpot, s["tsp"], s["tpos"], s["tbox"], s["tables"][True][1],
        s["counts"])
    e2, f2 = tpotmod.energy_forces(tpot, s["tsp"], s["tpos"], s["tbox"],
                                   s["tnl"], s["counts"])
    np.testing.assert_allclose(float(e0), float(e1), rtol=1e-12)
    np.testing.assert_allclose(float(e2), float(e1), rtol=1e-12)
    _close(f0, f1.numpy(), 1e-10)
    _close(f2, f1.numpy(), 1e-10)
    _close(w0, w1.numpy(), 1e-9)


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------


def _systems(rep):
    species, pos, h, origin, masses = water_system(rep)
    vel0 = 0.002 * np.random.default_rng(3).standard_normal(pos.shape)
    return dict(species=species, pos=pos, h=h, origin=origin, masses=masses,
                vel0=vel0)


def _run_pair(s, n_steps, nbr_kw=None, repulsion=False, force=None, dt=0.2):
    """The JAX and the port `Simulation`, default engine, NVE: init, an
    optional capacity forced on both, `n_steps` steps."""
    jpot, tpot = _pots(repulsion, caps=None)
    nbr_kw = dict(cutoff=5.1, **(nbr_kw or {}))
    jsim = jlat.Simulation(potential=jpot, species=s["species"],
                           masses=s["masses"],
                           nbr=jlat.NeighborConfig(**nbr_kw), dt=dt,
                           dtype=jnp.float64)
    tsim = tlat.Simulation(potential=tpot, species=s["species"],
                           masses=s["masses"],
                           nbr=tlat.NeighborConfig(**nbr_kw), dt=dt,
                           dtype=torch.float64, device="cpu")
    jst = jsim.init_state(s["pos"], jlat.Box(h=jnp.asarray(s["h"]),
                                             origin=jnp.asarray(s["origin"])),
                          vel=s["vel0"])
    tst = tsim.init_state(s["pos"], tlat.Box(h=torch.tensor(s["h"]),
                                             origin=torch.tensor(s["origin"])),
                          vel=s["vel0"])
    if force is not None:
        force(jsim, tsim)
        jsim._chunk_cache = {}
    jst, jrows = jsim.run(jst, n_steps, thermo_every=1)
    tst, trows = tsim.run(tst, n_steps, thermo_every=1)
    return jsim, jst, jrows, tsim, tst, trows


@pytest.fixture(scope="module")
def nve240():
    return _run_pair(_systems(2), 12, dt=0.5)


def test_default_engine_is_mirror(nve240):
    tsim = nve240[3]
    assert tsim.engine == "mirror" and tsim._roll_grid is None
    assert tsim._k_max == nve240[0]._k_max
    assert tsim._ang_cap == nve240[0]._ang_cap
    assert (tsim.potential.spec.angular_caps
            == nve240[0].potential.spec.angular_caps)


def test_default_nve_matches_jax(nve240):
    jsim, jst, jrows, tsim, tst, trows = nve240
    np.testing.assert_allclose(tsim.positions_input_order(tst),
                               jsim.positions_input_order(jst), atol=1e-10)
    np.testing.assert_allclose(tsim.forces_input_order(tst),
                               np.asarray(jst.force)[jsim.inv_order],
                               atol=1e-10
                               * np.abs(np.asarray(jst.force)).max())
    np.testing.assert_allclose([r["etotal"] for r in trows],
                               [r["etotal"] for r in jrows], rtol=1e-11)


def test_water_tile_runs_on_the_mirror_engine():
    """The 8 A tile (30 atoms) holds no 3x3x3 grid of any roll engine:
    the default runs the mirror engine, as `cellroll=True` does there."""
    s = _systems(1)
    jsim, jst, _, tsim, tst, _ = _run_pair(
        s, 4, nbr_kw=dict(ghost_capacity=1024, rebuild_every=2),
        repulsion=True)
    assert tsim.engine == "mirror"
    np.testing.assert_allclose(tsim.positions_input_order(tst),
                               jsim.positions_input_order(jst), atol=1e-10)
    _, tpot = _pots(True, caps=None)
    sim = tlat.Simulation(potential=tpot, species=s["species"],
                          masses=s["masses"],
                          nbr=tlat.NeighborConfig(cutoff=5.1,
                                                  ghost_capacity=1024),
                          dtype=torch.float64, device="cpu", cellroll=True)
    assert sim.engine == "mirror"  # a repulsion term on the xla hybrid
    sim.init_state(s["pos"], tlat.Box(h=torch.tensor(s["h"]),
                                      origin=torch.tensor(s["origin"])))
    assert sim.engine == "mirror" and sim._roll_grid is None


def _shrink_k_max(jsim, tsim):
    jsim._k_max = tsim._k_max = 88


def _shrink_caps(jsim, tsim):
    caps = (8, 0, 0, 4, 0, 0, 0)
    jsim.potential = jpotmod.ANIPotential(
        spec=dataclasses.replace(jsim.potential.spec, angular_caps=caps),
        params=jsim.potential.params)
    tsim.potential = tsim.potential.with_spec(
        dataclasses.replace(tsim.potential.spec, angular_caps=caps))


def _shrink_ang_cap(jsim, tsim):
    jsim._ang_cap = tsim._ang_cap = 16


REGROWS = {"ghost": (dict(ghost_capacity=1024), None),
           "k_max": ({}, _shrink_k_max),
           "angular": ({}, _shrink_caps),
           "mirror": ({}, _shrink_ang_cap)}


@pytest.mark.parametrize("kind", list(REGROWS))
def test_regrow_matches_jax(kind):
    nbr_kw, force = REGROWS[kind]
    jsim, jst, _, tsim, tst, _ = _run_pair(
        _systems(2), 2, nbr_kw=dict(rebuild_every=2, **nbr_kw), force=force)
    kinds = {"angular": "angular_caps"}.get(kind, kind)
    assert tsim.regrow_kinds[kinds] >= 1
    assert tsim.regrow_events == jsim.regrow_events >= 1
    assert tsim.nbr.ghost_capacity == jsim.nbr.ghost_capacity
    assert tsim._k_max == jsim._k_max
    assert tsim._ang_cap == jsim._ang_cap
    assert (tsim.potential.spec.angular_caps
            == jsim.potential.spec.angular_caps)
    np.testing.assert_allclose(tsim.positions_input_order(tst),
                               jsim.positions_input_order(jst), atol=1e-10)


def test_engine_resolution():
    """engine=None as the JAX package resolves it; an explicit engine wins
    over `cellroll`; a repulsion term on a hybrid runs the mirror (with
    a warning where the hybrid was named);
    pair_stage needs pallas_asn."""
    s = _systems(1)
    kw = dict(species=s["species"], masses=s["masses"], device="cpu",
              nbr=tlat.NeighborConfig(cutoff=5.1), dtype=torch.float64)
    _, plain = _pots(False, caps=None)
    _, rep = _pots(True, caps=None)
    assert tlat.Simulation(potential=plain, **kw).engine == "mirror"
    assert tlat.Simulation(potential=plain, cellroll=True,
                           **kw).engine == "xla"
    assert tlat.Simulation(potential=rep, cellroll=True, **kw).engine == \
        "mirror"
    for engine in ("mirror", "xla", "pallas", "pallas_full", "pallas_asn"):
        sim = tlat.Simulation(potential=plain, engine=engine, **kw)
        assert sim.engine == engine
    with pytest.warns(RuntimeWarning, match="'pallas' cannot run"):
        sim = tlat.Simulation(potential=rep, engine="pallas", **kw)
    assert sim.engine == "mirror"
    with pytest.raises(ValueError, match="pallas_asn"):
        tlat.Simulation(potential=plain, pair_stage="blocks", **kw)
    with pytest.raises(ValueError, match="engine"):
        tlat.Simulation(potential=plain, engine="roll", **kw)


@pytest.fixture(scope="module")
def nve810_mirror():
    s = _systems(3)
    _, tpot = _pots(False, caps=None)
    return s, tpot, _port_nve(s, tpot, "mirror")


def _port_nve(s, tpot, engine, n_steps=4):
    sim = tlat.Simulation(potential=tpot, species=s["species"],
                          masses=s["masses"],
                          nbr=tlat.NeighborConfig(cutoff=5.1,
                                                  ghost_capacity=8192,
                                                  rebuild_every=2),
                          dt=0.2, dtype=torch.float64, device="cpu",
                          engine=engine)
    st = sim.init_state(s["pos"], tlat.Box(h=torch.tensor(s["h"]),
                                           origin=torch.tensor(s["origin"])),
                        vel=s["vel0"])
    st, _ = sim.run(st, n_steps)
    return sim, st


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_hybrid_simulation_matches_mirror(nve810_mirror, engine):
    """The hybrids' NVE (810 atoms, 24 A box: 3^3 roll bins of side 8 A
    >= Rcr + ang_skin) against the mirror engine's: the same physics by
    another radial channel, positions within 1e-10 A."""
    s, tpot, (msim, mst) = nve810_mirror
    sim, st = _port_nve(s, tpot, engine)
    assert sim.engine == engine and sim._roll_grid.ncells == (3, 3, 3)
    assert sim._rlist_query == pytest.approx(4.5)
    np.testing.assert_allclose(sim.positions_input_order(st),
                               msim.positions_input_order(mst), atol=1e-10)
