"""`Simulation(sort_species=..., auto_angular_caps=...)`: the port's engine
options against the JAX package's `Simulation`.

System: WATER30 replicated 3x3x3 (810 atoms, 24 A box), NVE at dt 0.2 fs
from seeded velocities, f64, a rebuild every 2 steps. The JAX side runs its
mirror engine (its default; the asn engine would run its kernels in
interpret mode).

  * `sort_species=False` keeps the caller's species order (atoms sorted by
    cell only) and takes the masked MLP: over 4 steps the port's pe agrees
    with the JAX engine's to rtol 1e-11 and the positions and forces, in
    input order, to 1e-9. The port's sorted and unsorted runs agree to the
    same limits on the mirror engine (4 steps) and, through the plain
    versions on the CPU, on `pallas_full` (no repulsion; 1 step) and
    `pallas_asn` (with the XTB repulsion term; 2 steps).
  * Fixed caps (in the spec, or with `auto_angular_caps=False`) are kept at
    `init_state` and at every rebuild, in both packages; caps below the
    measured degree raise "angular_caps overflow" in both (the port's
    mirror and asn engines).
  * `pallas_full` with no caps and `auto_angular_caps=False` runs the
    `pallas` hybrid, as the JAX package routes it, with a RuntimeWarning
    naming both engines.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lammps_ani_tpu as jlat
import lammps_ani_torch as tlat
from lammps_ani_tpu.models import potential as jpotmod
from lammps_ani_tpu.models import zoo as jzoo
from lammps_ani_torch.models import zoo as tzoo

from .test_torch_neighbors import water_system

N_STEPS = 4
# the grid engines' plain versions are slow on the CPU at this size
STEPS_GRID = {"pallas_full": 1, "pallas_asn": 2}
FIXED = (20, 0, 0, 12, 0, 0, 0)  # above the measured degrees (H 16, O 12)
SMALL = (4, 0, 0, 2, 0, 0, 0)    # below them


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system():
    species, pos, h, origin, masses = water_system(3)
    vel0 = 0.002 * np.random.default_rng(3).standard_normal(pos.shape)
    return dict(species=species, pos=pos, h=h, origin=origin, masses=masses,
                vel0=vel0)


def pots(repulsion=False, caps=None):
    """The same synthetic ANI-2x weights in both packages."""
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


def nbr_kw():
    # k_max holds every neighbor within 7.1 A: with fixed caps the JAX
    # engine measures no degrees, so its init_state would truncate at the
    # default 64 (the port measures k_max in either case)
    return dict(cutoff=5.1, rebuild_every=2, ghost_capacity=4096, k_max=192)


def port_sim(s, tpot, **kw):
    return tlat.Simulation(potential=tpot, species=s["species"],
                           masses=s["masses"],
                           nbr=tlat.NeighborConfig(**nbr_kw()), dt=0.2,
                           dtype=torch.float64, device="cpu", **kw)


def jax_sim(s, jpot, **kw):
    return jlat.Simulation(potential=jpot, species=s["species"],
                           masses=s["masses"],
                           nbr=jlat.NeighborConfig(**nbr_kw()), dt=0.2,
                           dtype=jnp.float64, **kw)


def port_run(s, sim, n_steps=N_STEPS):
    st = sim.init_state(s["pos"], tlat.Box(h=torch.tensor(s["h"]),
                                           origin=torch.tensor(s["origin"])),
                        vel=s["vel0"])
    return sim.run(st, n_steps, thermo_every=1)


def jax_run(s, sim, n_steps=N_STEPS):
    st = sim.init_state(s["pos"], jlat.Box(h=jnp.asarray(s["h"]),
                                           origin=jnp.asarray(s["origin"])),
                        vel=s["vel0"])
    return sim.run(st, n_steps, thermo_every=1)


def assert_same_run(a_sim, a_st, a_rows, b_sim, b_st, b_rows):
    """pe rtol 1e-11 at every step; positions and forces in the caller's
    order within 1e-9."""
    pa = np.array([r["pe"] for r in a_rows])
    pb = np.array([r["pe"] for r in b_rows])
    np.testing.assert_allclose(pa, pb, rtol=1e-11, atol=0)
    np.testing.assert_allclose(a_sim.positions_input_order(a_st),
                               b_sim.positions_input_order(b_st), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(a_sim.forces_input_order(a_st),
                               b_sim.forces_input_order(b_st), rtol=0,
                               atol=1e-9)


@pytest.fixture(scope="module")
def unsorted_runs(system):
    """The mirror engine unsorted in both packages, and sorted in the
    port's."""
    jpot, tpot = pots()
    jsim = jax_sim(system, jpot, sort_species=False)
    jst, jrows = jax_run(system, jsim)
    tsim = port_sim(system, tpot, sort_species=False)
    tst, trows = port_run(system, tsim)
    ssim = port_sim(system, tpot)
    sst, srows = port_run(system, ssim)
    return dict(jax=(jsim, jst, jrows), port=(tsim, tst, trows),
                sorted=(ssim, sst, srows))


def test_unsorted_keeps_the_callers_species_order(system, unsorted_runs):
    jsim = unsorted_runs["jax"][0]
    tsim = unsorted_runs["port"][0]
    ssim = unsorted_runs["sorted"][0]
    assert tsim.species_counts is None and ssim.species_counts is not None
    # cell order alone, as the JAX engine orders them
    np.testing.assert_array_equal(tsim.order, np.asarray(jsim.order))
    sp = system["species"][tsim.order]
    assert np.any(np.diff(sp) < 0)  # not species-major
    assert np.all(np.diff(system["species"][ssim.order]) >= 0)


def test_unsorted_mirror_matches_jax(unsorted_runs):
    assert unsorted_runs["port"][0].engine == "mirror"
    assert_same_run(*unsorted_runs["port"], *unsorted_runs["jax"])


def test_unsorted_mirror_matches_sorted(unsorted_runs):
    assert_same_run(*unsorted_runs["port"], *unsorted_runs["sorted"])


@pytest.mark.parametrize("engine,repulsion", [("pallas_full", False),
                                              ("pallas_asn", True)])
def test_unsorted_grid_engine_matches_sorted(system, engine, repulsion):
    """The grid engines through the plain versions on the CPU: the masked
    MLP on unsorted atoms gives the sorted run's energies and forces."""
    _, tpot = pots(repulsion)
    runs = []
    for sort in (True, False):
        sim = port_sim(system, tpot, engine=engine, sort_species=sort)
        st, rows = port_run(system, sim, n_steps=STEPS_GRID[engine])
        assert sim.engine == engine
        assert (sim.species_counts is None) == (not sort)
        runs.append((sim, st, rows))
    assert_same_run(*runs[0], *runs[1])


@pytest.mark.parametrize("auto", [True, False])
def test_fixed_caps_are_kept(system, auto):
    """Caps in the spec stay the spec's after init_state and after the
    run's rebuilds, with or without auto_angular_caps, in both packages;
    the port still sizes its own capacities (k_max, the sub-list cap)."""
    jpot, tpot = pots(caps=FIXED)
    tsim = port_sim(system, tpot, auto_angular_caps=auto)
    jsim = jax_sim(system, jpot, auto_angular_caps=auto)
    tsim.init_state(system["pos"], tlat.Box(h=torch.tensor(system["h"]),
                                            origin=torch.tensor(
                                                system["origin"])))
    assert tsim.potential.spec.angular_caps == FIXED
    assert tsim._ang_cap is not None and tsim._k_max >= 8
    _, trows = port_run(system, tsim)
    assert tsim.potential.spec.angular_caps == FIXED
    assert tsim.regrow_kinds["angular_caps"] == 0
    if auto:
        # the JAX engine, once (its chunk compiles per caps)
        _, jrows = jax_run(system, jsim)
        assert tuple(jsim.potential.spec.angular_caps) == FIXED
        np.testing.assert_allclose([r["pe"] for r in trows],
                                   [r["pe"] for r in jrows], rtol=1e-11)


def test_caps_below_the_degree_raise_in_jax(system):
    jpot, _ = pots(caps=SMALL)
    jsim = jax_sim(system, jpot, auto_angular_caps=False)
    with pytest.raises(RuntimeError, match="angular_caps overflow"):
        jax_run(system, jsim)


@pytest.mark.parametrize("engine,repulsion", [("mirror", False),
                                              ("pallas_asn", True)])
def test_caps_below_the_degree_raise(system, engine, repulsion):
    """The mirror engine's rebuild check and the asn engine's per-species
    deficits (whose regrow would otherwise grow the caps) both raise."""
    _, tpot = pots(repulsion, caps=SMALL)
    sim = port_sim(system, tpot, engine=engine, auto_angular_caps=False)
    with pytest.raises(RuntimeError, match="angular_caps overflow"):
        port_run(system, sim, n_steps=1)
    assert sim.potential.spec.angular_caps == SMALL


def test_auto_caps_grow_instead(system):
    """The same small caps with auto_angular_caps on (set after init, as a
    regrow would find them): the run grows them and completes."""
    _, tpot = pots()
    sim = port_sim(system, tpot)
    st = sim.init_state(system["pos"], tlat.Box(
        h=torch.tensor(system["h"]), origin=torch.tensor(system["origin"])),
        vel=system["vel0"])
    sim.potential = sim.potential.with_spec(dataclasses.replace(
        sim.potential.spec, angular_caps=SMALL))
    sim.run(st, 2)
    assert sim.regrow_kinds["angular_caps"] >= 1
    caps = sim.potential.spec.angular_caps
    assert caps[0] > SMALL[0] and caps[3] > SMALL[3]


def test_grid_engines_without_caps_run_the_pallas_hybrid(system,
                                                         monkeypatch):
    _, tpot = pots()
    for engine in ("pallas_full", "pallas_asn"):
        with pytest.warns(RuntimeWarning, match=f"'{engine}'.*pallas "
                          "engine runs instead"):
            sim = port_sim(system, tpot, engine=engine,
                           auto_angular_caps=False)
        assert sim._roll_impl == "pallas"
        if engine == "pallas_full":
            port_run(system, sim, n_steps=1)
            assert sim.engine == "pallas"
            assert sim.potential.spec.angular_caps is None
    # the JAX package routes its LAT_ROLL_IMPL the same way
    jpot, _ = pots()
    monkeypatch.setenv("LAT_ROLL_IMPL", "pallas_full")
    assert jax_sim(system, jpot, auto_angular_caps=False)._roll_impl == \
        "pallas"
    # with caps, or measured caps, the engine stays
    assert port_sim(system, tpot, engine="pallas_full")._roll_impl == \
        "pallas_full"
    _, tcap = pots(caps=FIXED)
    assert port_sim(system, tcap, engine="pallas_full",
                    auto_angular_caps=False)._roll_impl == "pallas_full"
