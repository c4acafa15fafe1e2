"""RATTLE constraints in the port (lammps_ani_torch/md/constraints.py and
`Simulation(constraints=)`) against the JAX package, f64.

Units: `Rattle.from_bonds` (pairs equal, r0 to 1e-12) on WATER30's O-H
bonds; `project_positions` and `project_velocities` on seeded inputs (the
tile's positions with a molecule moved across a face, so the minimum
image is taken) to 1e-12 of the largest entry; the per-atom table sums
each atom's corrections in constraint order.

Engine level: the JAX test's settings (tests/test_features.py,
test_rattle_constrains_bonds: WATER30, the 20 O-H bonds, dt 0.2 fs, NVE,
10 steps, a rebuild every 2) from the same explicit velocities on the
port's mirror engine and the JAX `Simulation`: dof 67, max_violation
below 1e-6 A, positions to 1e-10 A and velocities to 1e-9 A/fs (measured
2.9e-14 and 2.2e-14). The port's `pallas_asn` (WATER30 x 3^3, 810 atoms),
`pallas_full` (x 2^3 at skin 1, 240 atoms) and the `xla` and `pallas`
hybrids (810 atoms) on their plain paths against the port's mirror engine
on the same system, 3 steps, positions to 1e-10 A. Constrained runs under
NoseHooverNPT, NVE + BerendsenBarostat and Langevin stay finite and hold
their bonds (NoseHoover and NVE: the restart and the JAX comparison); a
constrained restart resumes bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lammps_ani_tpu as jlat
import lammps_ani_torch as tlat
from lammps_ani_tpu.md import constraints as jcons
from lammps_ani_torch.io import restart as trest
from lammps_ani_torch.md import constraints as tcons
from lammps_ani_torch.md import integrate as tint
from lammps_ani_torch.tools import pdb as tpdb

from .test_torch_mirror import _pots
from .test_torch_neighbors import water_system

NBR = dict(cutoff=5.1, skin=2.0, k_max=128, ghost_capacity=1024,
           rebuild_every=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def water_bonds(rep=1):
    species, pos, h, origin, masses = water_system(rep)
    return species, pos, h, origin, masses, tpdb.detect_bonds(species, pos,
                                                              h)


@pytest.fixture(scope="module")
def pots():
    return _pots(False, caps=None)


def test_from_bonds_matches_jax():
    species, pos, h, _, _, bonds = water_bonds()
    assert len(bonds) == 20
    jr = jcons.Rattle.from_bonds(bonds, pos, h)
    tr = tcons.Rattle.from_bonds(bonds, pos, h)
    assert tr.pairs == jr.pairs and tr.n_constraints == 20
    np.testing.assert_allclose(tr.r0, jr.r0, rtol=0, atol=1e-12)
    # bond rows as a data file holds them: (type, i, j)
    rows = np.array([(1, i, j) for i, j in bonds])
    assert tcons.Rattle.from_bonds(rows, pos, h).pairs == jr.pairs
    assert tcons.Rattle.from_bonds([], pos, h).n_constraints == 0


def test_per_atom_table_order():
    """Each atom's slots hold its constraints in constraint order, the
    i side as -1, the j side as +1, padding as constraint 0 with sign 0."""
    r = tcons.Rattle(pairs=((0, 1), (0, 2), (3, 0)), r0=(1.0, 1.0, 1.0))
    tab = r.tables(5, torch.float64, "cpu")
    assert tab.slot.tolist() == [[0, 1, 2], [0, 0, 0], [1, 0, 0],
                                 [2, 0, 0], [0, 0, 0]]
    assert tab.sign.tolist() == [[-1, -1, 1], [1, 0, 0], [1, 0, 0],
                                 [-1, 0, 0], [0, 0, 0]]
    assert r.tables(5, torch.float64, "cpu") is tab


def test_projections_match_jax():
    species, pos, h, origin, masses, bonds = water_bonds()
    rng = np.random.default_rng(5)
    # molecule 0 across the +x face: the O stays, its H atoms wrap
    pos = pos.copy()
    pos[:3] += np.array([4.0 - 0.3 - pos[0, 0], 0.0, 0.0])
    pos[1:3, 0] -= np.where(pos[1:3, 0] > 4.0, 8.0, 0.0)
    jr = jcons.Rattle.from_bonds(bonds, pos, h)
    tr = tcons.Rattle.from_bonds(bonds, pos, h)
    pos_old = pos + 0.01 * rng.standard_normal(pos.shape)
    pos_new = pos_old + 0.03 * rng.standard_normal(pos.shape)
    vel = 0.01 * rng.standard_normal(pos.shape)
    jbox = jlat.Box(h=jnp.asarray(h), origin=jnp.asarray(origin))
    tbox = tlat.Box(h=torch.tensor(h), origin=torch.tensor(origin))
    j = lambda x: jnp.asarray(x)  # noqa: E731
    t = lambda x: torch.tensor(x)  # noqa: E731
    jp, jv = jr.project_positions(j(pos_new), j(pos_old), j(vel), j(masses),
                                  jbox, 0.2)
    tp, tv = tr.project_positions(t(pos_new), t(pos_old), t(vel), t(masses),
                                  tbox, 0.2)
    for got, ref in ((tp, jp), (tv, jv)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    assert float(tr.max_violation(tp, tbox)) < 1e-8
    np.testing.assert_allclose(float(tr.max_violation(tp, tbox)),
                               float(jr.max_violation(jp, jbox)), rtol=0,
                               atol=1e-12)
    jv2 = np.asarray(jr.project_velocities(jp, j(vel), j(masses), jbox))
    tv2 = tr.project_velocities(tp, t(vel), t(masses), tbox).numpy()
    assert np.abs(tv2 - jv2).max() <= 1e-12 * np.abs(jv2).max()


def _port_sim(tpot, species, masses, rat, dt=0.2, engine=None, nbr=NBR,
              **kw):
    return tlat.Simulation(potential=tpot, species=species, masses=masses,
                           nbr=tlat.NeighborConfig(**nbr), dt=dt,
                           dtype=torch.float64, device="cpu",
                           constraints=rat, engine=engine, **kw)


def _tbox(h, origin):
    return tlat.Box(h=torch.tensor(h), origin=torch.tensor(origin))


def test_constrained_nve_matches_jax(pots):
    jpot, tpot = pots
    species, pos, h, origin, masses, bonds = water_bonds()
    vel0 = 0.002 * np.random.default_rng(3).standard_normal(pos.shape)
    jr = jcons.Rattle.from_bonds(bonds, pos, h)
    jsim = jlat.Simulation(potential=jpot, species=species, masses=masses,
                           nbr=jlat.NeighborConfig(**NBR), dt=0.2,
                           dtype=jnp.float64, constraints=jr)
    jst = jsim.init_state(pos, jlat.Box(h=jnp.asarray(h),
                                        origin=jnp.asarray(origin)),
                          vel=vel0)
    jst, _ = jsim.run(jst, 10)
    tr = tcons.Rattle.from_bonds(bonds, pos, h)
    sim = _port_sim(tpot, species, masses, tr)
    assert sim.dof == jsim.dof == 3 * 30 - 3 - 20
    st = sim.init_state(pos, _tbox(h, origin), vel=vel0)
    st, rows = sim.run(st, 10, thermo_every=5)
    assert sim.engine == "mirror" and st.step == 10
    got = sim.positions_input_order(st)
    assert float(tr.max_violation(torch.tensor(got), st.box)) < 1e-6
    np.testing.assert_allclose(got, jsim.positions_input_order(jst), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(sim.velocities_input_order(st),
                               jsim.velocities_input_order(jst), rtol=0,
                               atol=1e-9)
    assert np.isfinite(rows[-1]["etotal"])
    # velocities drawn at init_state: exactly 300 K over the reduced dof
    st = sim.init_state(pos, _tbox(h, origin), temp=300.0, seed=4)
    temp = float(tint.temperature(st.vel, sim.masses, sim.dof))
    assert temp == pytest.approx(300.0, rel=1e-12)


def _constrained_run(tpot, engine, rep, skin, _done={}):
    """(positions, velocities) in caller order after 3 constrained NVE
    steps on `engine` (each system's mirror run made once)."""
    key = (engine, rep, skin)
    if key not in _done:
        species, pos, h, origin, masses, bonds = water_bonds(rep)
        vel0 = 0.002 * np.random.default_rng(3).standard_normal(pos.shape)
        tr = tcons.Rattle.from_bonds(bonds, pos, h)
        nbr = dict(NBR, skin=skin, k_max=160, ghost_capacity=8192)
        sim = _port_sim(tpot, species, masses, tr, engine=engine, nbr=nbr)
        st = sim.init_state(pos, _tbox(h, origin), vel=vel0)
        st, _ = sim.run(st, 3)
        assert sim.engine == engine
        got = sim.positions_input_order(st)
        assert float(tr.max_violation(torch.tensor(got), st.box)) < 1e-6
        _done[key] = (got, sim.velocities_input_order(st))
    return _done[key]


@pytest.mark.parametrize("engine,rep,skin", [("pallas_asn", 3, 2.0),
                                             ("pallas_full", 2, 1.0),
                                             ("xla", 3, 2.0),
                                             ("pallas", 3, 2.0)])
def test_grid_engines_match_mirror(pots, engine, rep, skin):
    _, tpot = pots
    pos, vel = _constrained_run(tpot, engine, rep, skin)
    ref_pos, ref_vel = _constrained_run(tpot, "mirror", rep, skin)
    np.testing.assert_allclose(pos, ref_pos, rtol=0, atol=1e-10)
    np.testing.assert_allclose(vel, ref_vel, rtol=0, atol=1e-9)


ENSEMBLES = {
    "npt": dict(integrator=tint.NoseHooverNPT(temp=300.0, tdamp=20.0,
                                              press=1.0, pdamp=100.0)),
    "berendsen": dict(barostat=tint.BerendsenBarostat(press=1.0,
                                                      pdamp=100.0)),
    "langevin": dict(integrator=tint.Langevin(
        temp=300.0, damp=20.0, generator=torch.Generator().manual_seed(2))),
}


@pytest.mark.parametrize("ensemble", sorted(ENSEMBLES))
def test_constrained_ensembles_hold_bonds(pots, ensemble):
    """The bonds hold to 1e-6 A after every step; under the Berendsen
    barostat, whose rescale of the box and positions comes after the
    projections (the JAX step's order), to the last rescale's |s - 1| r0."""
    _, tpot = pots
    species, pos, h, origin, masses, bonds = water_bonds()
    tr = tcons.Rattle.from_bonds(bonds, pos, h)
    sim = _port_sim(tpot, species, masses, tr, dt=0.2, **ENSEMBLES[ensemble])
    st = sim.init_state(pos, _tbox(h, origin), temp=300.0, seed=4)
    st, rows = sim.run(st, 11, thermo_every=1)
    h11 = st.box.h.clone()
    st, last = sim.run(st, 1, thermo_every=1)
    assert all(np.isfinite(r[k]) for r in rows + last
               for k in ("pe", "ke", "temp", "press", "vol"))
    assert np.allclose(st.box.h.numpy(), h) == (ensemble == "langevin")
    got = torch.tensor(sim.positions_input_order(st))
    slack = 0.0
    if ensemble == "berendsen":
        scale = float(st.box.h[0, 0] / h11[0, 0])
        assert scale != 1.0
        slack = abs(scale - 1.0) * max(tr.r0)
    assert float(tr.max_violation(got, st.box)) < 1e-6 + slack


def test_constrained_restart_bit_for_bit(tmp_path, pots):
    _, tpot = pots
    species, pos, h, origin, masses, bonds = water_bonds()
    tr = tcons.Rattle.from_bonds(bonds, pos, h)
    nvt = tint.NoseHoover(temp=300.0, tdamp=20.0)
    sim = _port_sim(tpot, species, masses, tr, integrator=nvt)
    st = sim.init_state(pos, _tbox(h, origin), temp=300.0, seed=5)
    st, _ = sim.run(st, 4)
    trest.save_restart(tmp_path / "ck.npz", sim, st)
    st_cont, _ = sim.run(st, 4)
    sim2 = _port_sim(tpot, species, masses,
                     dataclasses.replace(tr), integrator=nvt)
    st2 = trest.load_restart(tmp_path / "ck.npz", sim2)
    st2, _ = sim2.run(st2, 4)
    for f in ("positions", "velocities", "forces"):
        np.testing.assert_array_equal(
            getattr(sim2, f"{f}_input_order")(st2),
            getattr(sim, f"{f}_input_order")(st_cont), err_msg=f)
