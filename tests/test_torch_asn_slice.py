"""The port's asn MD path (`Simulation(engine="pallas_asn")`,
ANI-2x + XTB repulsion) vs the JAX package: trajectory, derived sizing,
regrows.

WATER30 replicated 3x3x3 (810 atoms, 24 A box: 3x3x3 coarse bins of side
8 A >= Rcr + skin = 7.1 A), f64, NVE, explicit caller-order velocities,
4 steps with a rebuild every 2. The JAX side runs its mirror engine, the
plain reference the JAX package holds its own kernels against, so the
port's asn engine (kernels' plain versions and the explicit backward) is
compared with an independent path. The derived sizing is compared with
what the JAX `Simulation` derives under LAT_ROLL_IMPL=pallas_asn (its
setup only; no kernel runs).

Tolerances: positions 1e-10 A, pe rtol 1e-11, virial 1e-8, velocities
1e-12 A/fs (f64 sums taken in another order). A run whose capacity was
shrunk first regrows it and ends at the unshrunk run's positions
(1e-10: grown capacities add dead slots only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lammps_ani_tpu as jlat
import lammps_ani_torch as tlat
from lammps_ani_tpu.models import zoo as jzoo
from lammps_ani_torch.models import zoo as tzoo
from lammps_ani_torch.ops import cell_roll as tcr

from .test_torch_neighbors import water_system

DT = 0.2
N_STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions are chains of small tensor operations. When
    several test processes share a machine, each with one OpenMP thread per
    core, those threads wait on one another at every operation and this
    file takes many times longer; one thread keeps its time flat."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nbr(mod, **kw):
    return mod.NeighborConfig(cutoff=5.1, skin=2.0, k_max=160,
                              ghost_capacity=8192, rebuild_every=2, **kw)


@pytest.fixture(scope="module")
def system():
    species, pos, h, origin, masses = water_system(3)
    vel0 = 0.002 * np.random.default_rng(3).standard_normal(pos.shape)
    jpot = jzoo.ani2x(num_models=1, dtype=jnp.float64, repulsion=True)
    tpot = tzoo.ani2x(num_models=1, dtype=torch.float64, device="cpu",
                      repulsion=True, params=tzoo.params_from_numpy(
                          jax.tree.map(np.asarray, jpot.params)))
    return dict(species=species, pos=pos, h=h, origin=origin, masses=masses,
                vel0=vel0, jpot=jpot, tpot=tpot)


def _port_box(s):
    return tlat.Box(h=torch.tensor(s["h"]), origin=torch.tensor(s["origin"]))


def _jax_box(s):
    return jlat.Box(h=jnp.asarray(s["h"]), origin=jnp.asarray(s["origin"]))


def _port_start(s, **nbr_kw):
    """(sim, state) of the port's asn engine at the start state."""
    sim = tlat.Simulation(potential=s["tpot"], species=s["species"],
                          masses=s["masses"], nbr=_nbr(tlat, **nbr_kw), dt=DT,
                          dtype=torch.float64, device="cpu",
                          engine="pallas_asn")
    return sim, sim.init_state(s["pos"], _port_box(s), vel=s["vel0"])


@pytest.fixture(scope="module")
def nve(system):
    mp = pytest.MonkeyPatch()
    mp.setenv("LAT_ROLL_IMPL", "mirror-off")
    try:
        jsim = jlat.Simulation(potential=system["jpot"],
                               species=system["species"],
                               masses=system["masses"], nbr=_nbr(jlat),
                               dt=DT, dtype=jnp.float64)
        jst = jsim.init_state(system["pos"], _jax_box(system),
                              vel=system["vel0"], seed=11)
        jst, jrows = jsim.run(jst, N_STEPS, thermo_every=1)
    finally:
        mp.undo()
    tsim, tst0 = _port_start(system)
    tst, trows = tsim.run(tst0, N_STEPS, thermo_every=1)
    return dict(jsim=jsim, jst=jst, jrows=jrows, tsim=tsim, tst0=tst0,
                tst=tst, trows=trows)


def test_default_engine_is_asn_with_repulsion(nve):
    sim = nve["tsim"]
    assert sim.engine == "pallas_asn"
    assert sim.potential.spec.repulsion is not None
    assert sim._roll_grid.ncells == (3, 3, 3)
    # the state does not carry the rebuild's tables
    assert nve["tst0"].bins is None and nve["tst"].bins is None
    assert sim.regrow_events == 0 and not any(sim.regrow_kinds.values())


def test_nve_positions_match_jax(nve):
    np.testing.assert_allclose(nve["tsim"].positions_input_order(nve["tst"]),
                               nve["jsim"].positions_input_order(nve["jst"]),
                               atol=1e-10)


def test_nve_energy_and_virial_match_jax(nve):
    np.testing.assert_allclose(float(nve["tst"].pe), float(nve["jst"].pe),
                               rtol=1e-11)
    np.testing.assert_allclose(nve["tst"].virial.numpy(),
                               np.asarray(nve["jst"].virial), atol=1e-8)


def test_nve_velocities_match_jax(nve):
    np.testing.assert_allclose(nve["tsim"].velocities_input_order(nve["tst"]),
                               nve["jsim"].velocities_input_order(nve["jst"]),
                               atol=1e-12)


def test_nve_forces_match_jax(nve):
    """The final state's forces in caller order (kcal/mol/A)."""
    sim = nve["tsim"]
    ref = np.asarray(nve["jsim"].forces_input_order(nve["jst"]))
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(nve["tst"].force.numpy()[sim.inv_order], ref,
                               atol=1e-8)


@pytest.mark.parametrize("key", ["pe", "ke", "etotal", "temp", "press",
                                 "vol", "density"])
def test_nve_thermo_rows_match_jax(nve, key):
    """rtol 1e-11: f64 rounding, summed in other orders."""
    assert [r["step"] for r in nve["trows"]] == [1, 2, 3, 4]
    np.testing.assert_allclose([r[key] for r in nve["trows"]],
                               [r[key] for r in nve["jrows"]],
                               rtol=1e-11, atol=1e-11)


def test_repulsion_moves_the_trajectory(system, nve):
    """The same run without the repulsion term ends elsewhere: the term
    reaches the forces."""
    pot = system["tpot"].with_spec(dataclasses.replace(system["tpot"].spec,
                                                       repulsion=None))
    sim, st = _port_start(dict(system, tpot=pot))
    st, _ = sim.run(st, N_STEPS)
    diff = np.abs(sim.positions_input_order(st)
                  - nve["tsim"].positions_input_order(nve["tst"])).max()
    assert diff > 1e-6


# --- derived sizing -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_asn_setup(system):
    """The JAX `Simulation` under LAT_ROLL_IMPL=pallas_asn, set up to its
    derived capacities (no kernel runs)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LAT_ROLL_IMPL", "pallas_asn")
    try:
        jsim = jlat.Simulation(potential=system["jpot"],
                               species=system["species"],
                               masses=system["masses"], nbr=_nbr(jlat),
                               dt=DT, dtype=jnp.float64, cellroll=True)
        jbox = _jax_box(system)
        jsim._spatial_sort(system["pos"], jbox)
        jpos = jnp.asarray(system["pos"][jsim.order])
        jsim._setup_grids(jpos, jbox)
        jsim._derive_angular_caps(jpos, jbox)
    finally:
        mp.undo()
    return jsim


def test_derived_sizing_matches_jax_asn_engine(nve, jax_asn_setup):
    tsim, jsim = nve["tsim"], jax_asn_setup
    np.testing.assert_array_equal(tsim.order, jsim.order)
    assert tsim._roll_grid.ncells == jsim._roll_grid.ncells
    assert tsim._roll_grid.cap == jsim._roll_grid.cap
    assert tsim._sections == jsim._rad_sections
    assert tsim.kpad == 128
    assert (tsim.potential.spec.angular_caps
            == jsim.potential.spec.angular_caps)
    assert tsim._tiers is None and jsim._ang_tiers is None  # < 4096 atoms
    assert tsim._k_max == jsim._k_max


@pytest.mark.parametrize("seed", [1, 2])
def test_derived_tiers_match_jax(nve, jax_asn_setup, monkeypatch, seed):
    """The tier ladder from a seeded degree matrix of 6,000 atoms (tiers
    start at 4,096), with the row margins of both packages' `Simulation`."""
    rng = np.random.default_rng(seed)
    n = 6000
    cnt = np.zeros((n, 7), np.int64)
    cnt[:, 0] = np.clip(rng.poisson(11, n), 2, 20)
    cnt[:, 3] = np.clip(rng.poisson(5, n), 1, 12)
    caps = (24, 0, 0, 16, 0, 0, 0)
    monkeypatch.setattr(nve["tsim"], "n_atoms", n)
    monkeypatch.setattr(jax_asn_setup, "n_atoms", n)
    got = nve["tsim"]._derive_tiers(cnt, caps)
    ref = jax_asn_setup._derive_tiers(cnt, caps)
    assert got is not None and len(got) >= 2
    assert got == ref
    assert got[-1][0] == caps


# --- regrows --------------------------------------------------------------------


def _shrink(kind, sim):
    caps = sim.potential.spec.angular_caps
    if kind == "sections":
        sim._sections = tuple((s, k // 2) for s, k in sim._sections)
    elif kind == "angular_caps":
        sim.potential = sim.potential.with_spec(dataclasses.replace(
            sim.potential.spec,
            angular_caps=tuple(4 if c else 0 for c in caps)))
    elif kind == "tier_rows":
        # two tiers of one 256-row block each: 512 rows for 810 atoms
        sim._tiers = ((tuple(max(4, c - 4) if c else 0 for c in caps), 64),
                      (caps, 64))
    elif kind == "roll":
        sim._roll_grid = tcr.RollGrid(ncells=sim._roll_grid.ncells, cap=16)


@pytest.mark.parametrize("kind", ["sections", "angular_caps", "tier_rows",
                                  "roll"])
def test_each_regrow_kind_recovers_the_trajectory(system, nve, kind):
    sim, st = _port_start(system)
    before = {"sections": sim._sections, "roll": sim._roll_grid.cap,
              "angular_caps": sim.potential.spec.angular_caps}
    _shrink(kind, sim)
    st, _ = sim.run(st, N_STEPS)
    assert sim.regrow_events >= 1
    assert sim.regrow_kinds[kind] >= 1
    assert all(v == 0 for k, v in sim.regrow_kinds.items() if k != kind)
    np.testing.assert_allclose(sim.positions_input_order(st),
                               nve["tsim"].positions_input_order(nve["tst"]),
                               atol=1e-10)
    # grown to at least what the run needs, by whole rounding steps
    if kind == "sections":
        for (_, k), (_, k0) in zip(sim._sections, before["sections"]):
            assert k0 // 2 < k <= k0 + 8 and (k - k0 // 2) % 4 == 0
    elif kind == "angular_caps":
        caps = sim.potential.spec.angular_caps
        assert all(c % 4 == 0 and c <= c0 for c, c0
                   in zip(caps, before["angular_caps"]))
    elif kind == "tier_rows":
        assert sim._tiers[-1][1] > 64
        assert sim._tiers[-1][0] == before["angular_caps"]
    else:
        assert 16 < sim._roll_grid.cap <= before["roll"]
