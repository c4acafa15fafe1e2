"""Collective-variable biases in the port (lammps_ani_torch/md/bias.py and
`Simulation(extra_force=)`) against the JAX package, f64.

Units: the three CVs, `HarmonicBias.energy` and `force` and `combine` on
seeded positions that straddle no face (a 5 A cluster in a 20 A box),
to 1e-12; the periodic delta wraps (a dihedral near pi against a center
near -pi). The fault of the JAX CVs, which ignore the box: a water
molecule moved across a face (as the engine holds it after a rebuild's
wrap) gives the JAX `distance_cv` about a box length and the port's the
bond length.

Engine level: WATER30 under NVE (dt 0.1 fs, 10 steps, a rebuild every 2)
with `combine` of a distance, an angle and a dihedral restraint (k 40 and
400 kcal/mol) on atoms that straddle no face, from the same velocities,
on the port's mirror engine and the JAX `Simulation`: positions to 1e-10
A, velocities to 1e-9 A/fs. The caller-order contract on a shuffled
input; the force of `init_state` carries the bias, which sees step 0
there and the state's step before the increment in `run`; `run_windows`
gives one sample array per window; a stiff bias holds the CV under
Langevin, as tests/test_features.py asks of the JAX engine.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lammps_ani_tpu as jlat
import lammps_ani_torch as tlat
from lammps_ani_tpu.md import bias as jbias
from lammps_ani_torch.md import bias as tbias
from lammps_ani_torch.md import integrate as tint
from lammps_ani_torch.ops import neighbors as tnb

from . import fixtures
from .test_torch_mirror import _pots

NBR = dict(cutoff=5.1, skin=2.0, k_max=128, ghost_capacity=1024,
           rebuild_every=2)
# atoms of WATER30 near its middle: molecule 7 (21-23) and its neighbors
CV_ATOMS = dict(distance=(21, 22), angle=(22, 21, 23),
                dihedral=(22, 21, 15, 16))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pots():
    return _pots(False, caps=None)


def both(name, *idx):
    return (getattr(jbias, f"{name}_cv")(*idx),
            getattr(tbias, f"{name}_cv")(*idx))


def boxes(h, origin):
    return (jlat.Box(h=jnp.asarray(h), origin=jnp.asarray(origin)),
            tlat.Box(h=torch.tensor(h), origin=torch.tensor(origin)))


@pytest.fixture(scope="module")
def cluster():
    pos = np.random.default_rng(7).uniform(-2.5, 2.5, (12, 3))
    return pos, boxes(np.diag([20.0, 21.0, 22.0]), np.full(3, -10.0))


@pytest.mark.parametrize("name,idx", [("distance", (0, 5)),
                                      ("angle", (1, 4, 9)),
                                      ("dihedral", (2, 7, 3, 11))])
def test_cvs_match_jax(cluster, name, idx):
    pos, (jbox, tbox) = cluster
    jcv, tcv = both(name, *idx)
    for box in (tbox, None):
        got = float(tcv(torch.tensor(pos), box))
        assert got == pytest.approx(float(jcv(jnp.asarray(pos), jbox)),
                                    abs=1e-12)
    jb = jbias.HarmonicBias(cv=jcv, k=40.0, center=0.5)
    tb = tbias.HarmonicBias(cv=tcv, k=40.0, center=0.5)
    assert float(tb.energy(torch.tensor(pos), tbox)) == pytest.approx(
        float(jb.energy(jnp.asarray(pos), jbox)), abs=1e-12)
    ref = np.asarray(jb.force(jnp.asarray(pos), jbox))
    got = tb.force(torch.tensor(pos), tbox)
    assert not got.requires_grad
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def test_combine_matches_jax(cluster):
    pos, (jbox, tbox) = cluster
    specs = [("distance", (0, 5), 1.5), ("angle", (1, 4, 9), 1.2),
             ("dihedral", (2, 7, 3, 11), -2.0)]
    jbs, tbs = [], []
    for name, idx, center in specs:
        jcv, tcv = both(name, *idx)
        period = 2 * np.pi if name == "dihedral" else None
        jbs.append(jbias.HarmonicBias(jcv, 40.0, center, period))
        tbs.append(tbias.HarmonicBias(tcv, 40.0, center, period))
    ref = np.asarray(jbias.combine(jbs)(jnp.asarray(pos), jbox))
    with torch.no_grad():  # as in a step
        got = tbias.combine(tbs)(torch.tensor(pos), tbox, 3).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_periodic_delta_wraps():
    """A dihedral near +pi against a center near -pi: the delta wraps to
    the short way round, as the JAX bias's."""
    pos = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                    [1.0, -1.0, 0.05]])
    jcv, tcv = both("dihedral", 0, 1, 2, 3)
    phi = float(tcv(torch.tensor(pos), None))
    assert abs(phi) > 3.0
    center = -np.sign(phi) * (np.pi - 0.02)
    wrapped = phi - center - 2 * np.pi * np.round((phi - center)
                                                  / (2 * np.pi))
    assert abs(wrapped) < 0.2
    tb = tbias.HarmonicBias(tcv, 40.0, center, periodic=2 * np.pi)
    jb = jbias.HarmonicBias(jcv, 40.0, center, periodic=2 * np.pi)
    e = float(tb.energy(torch.tensor(pos), None))
    assert e == pytest.approx(0.5 * 40.0 * wrapped ** 2, rel=1e-12)
    assert e == pytest.approx(float(jb.energy(jnp.asarray(pos), None)),
                              rel=1e-12)
    open_e = float(tbias.HarmonicBias(tcv, 40.0, center).energy(
        torch.tensor(pos), None))
    assert open_e > 100 * e


def test_distance_cv_across_a_face():
    """The fault: atoms wrapped one by one leave a molecule across a face;
    the JAX CV, which ignores the box, jumps by about a box length."""
    pos = fixtures.WATER30_POS.copy()
    h, origin = fixtures.WATER30_BOX, fixtures.WATER30_ORIGIN
    bond = float(np.linalg.norm(pos[0] - pos[1]))
    pos[:3] += np.array([3.98 - pos[0, 0], 0.0, 0.0])
    jbox, tbox = boxes(h, origin)
    wrapped = tnb.wrap_positions(torch.tensor(pos), tbox)
    assert float(wrapped[1, 0] - wrapped[0, 0]) < -4.0  # H across the face
    jcv, tcv = both("distance", 0, 1)
    j_d = float(jcv(jnp.asarray(wrapped.numpy()), jbox))
    t_d = float(tcv(wrapped, tbox))
    assert j_d > 7.0
    assert t_d == pytest.approx(bond, abs=1e-12)


def _restraints(mod):
    specs = [("distance", 1.0, 400.0, None), ("angle", 1.8, 40.0, None),
             ("dihedral", 0.5, 40.0, 2 * np.pi)]
    return [mod.HarmonicBias(getattr(mod, f"{n}_cv")(*CV_ATOMS[n]), k, c, p)
            for n, c, k, p in specs]


def _port_sim(tpot, species, masses, extra, integrator=None, dt=0.1):
    return tlat.Simulation(potential=tpot, species=species, masses=masses,
                           nbr=tlat.NeighborConfig(**NBR), dt=dt,
                           dtype=torch.float64, device="cpu",
                           integrator=integrator, extra_force=extra)


def test_biased_nve_matches_jax(pots):
    jpot, tpot = pots
    species, masses = fixtures.WATER30_SPECIES, fixtures.MASSES[
        fixtures.WATER30_SPECIES]
    pos, h, origin = (fixtures.WATER30_POS, fixtures.WATER30_BOX,
                      fixtures.WATER30_ORIGIN)
    vel0 = 0.002 * np.random.default_rng(3).standard_normal(pos.shape)
    jbox, tbox = boxes(h, origin)
    jsim = jlat.Simulation(potential=jpot, species=species, masses=masses,
                           nbr=jlat.NeighborConfig(**NBR), dt=0.1,
                           dtype=jnp.float64,
                           extra_force=jbias.combine(_restraints(jbias)))
    jst = jsim.init_state(pos, jbox, vel=vel0)
    jst, _ = jsim.run(jst, 10)
    sim = _port_sim(tpot, species, masses,
                    tbias.combine(_restraints(tbias)))
    st = sim.init_state(pos, tbox, vel=vel0)
    st, _ = sim.run(st, 10)
    np.testing.assert_allclose(sim.positions_input_order(st),
                               jsim.positions_input_order(jst), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(sim.velocities_input_order(st),
                               jsim.velocities_input_order(jst), rtol=0,
                               atol=1e-9)
    # the bias adds to the force only, not to the virial
    free = _port_sim(tpot, species, masses, None)
    st_free = free.init_state(pos, tbox, vel=vel0)
    st0 = sim.init_state(pos, tbox, vel=vel0)
    assert torch.equal(st0.virial, st_free.virial)


def test_caller_order_and_step(pots):
    """Shuffled atoms with the bias's indices shuffled alike give the same
    forces in the caller's order; the callable sees caller-order
    positions, step 0 at init_state and each state's step before the
    increment."""
    _, tpot = pots
    species = fixtures.WATER30_SPECIES
    masses = fixtures.MASSES[species]
    pos = fixtures.WATER30_POS
    _, tbox = boxes(fixtures.WATER30_BOX, fixtures.WATER30_ORIGIN)
    perm = np.random.default_rng(2).permutation(30)
    inv = np.argsort(perm)
    seen = []

    def make(order_map):
        bias = tbias.HarmonicBias(
            tbias.distance_cv(*order_map[list(CV_ATOMS["distance"])]),
            400.0, 1.0)

        def extra(p, box, step):
            seen.append((step, p[order_map[21]].clone()))
            return bias.force(p, box, step)
        return extra

    wrapped = tnb.wrap_positions(torch.tensor(pos),
                                                tbox).numpy()
    sim = _port_sim(tpot, species, masses, make(np.arange(30)))
    st = sim.init_state(pos, tbox)
    f_ref = sim.forces_input_order(st)
    assert seen[0][0] == 0
    assert torch.equal(seen[0][1], torch.as_tensor(wrapped[21]))
    shuf = _port_sim(tpot, species[perm], masses[perm], make(inv))
    st_s = shuf.init_state(pos[perm], tbox)
    f_s = shuf.forces_input_order(st_s)[inv]
    assert np.abs(f_s - f_ref).max() <= 1e-12 * np.abs(f_ref).max()
    # the bias is in the force of init_state
    free = _port_sim(tpot, species, masses, None)
    f_free = free.forces_input_order(free.init_state(pos, tbox))
    fb = make(np.arange(30))(torch.tensor(wrapped), tbox, 0).numpy()
    np.testing.assert_allclose(f_ref - f_free, fb, rtol=0, atol=1e-10)
    assert np.abs(fb).max() > 1.0
    seen.clear()
    sim.run(st, 3)
    assert [s for s, _ in seen] == [0, 1, 2]


def test_run_windows(pots):
    _, tpot = pots
    species = fixtures.WATER30_SPECIES
    masses = fixtures.MASSES[species]
    _, tbox = boxes(fixtures.WATER30_BOX, fixtures.WATER30_ORIGIN)
    samples = tbias.run_windows(
        lambda extra: _port_sim(tpot, species, masses, extra),
        fixtures.WATER30_POS, tbox, centers=[0.95, 1.05], k=400.0,
        cv_factory=lambda: tbias.distance_cv(*CV_ATOMS["distance"]),
        steps_per_window=4, sample_every=2)
    assert len(samples) == 2
    assert all(s.shape == (2,) and np.all(np.isfinite(s)) for s in samples)
    assert np.all((samples[0] > 0.8) & (samples[0] < 1.2))


def test_stiff_bias_holds_cv_under_langevin(pots):
    _, tpot = pots
    species = fixtures.WATER30_SPECIES
    masses = fixtures.MASSES[species]
    _, tbox = boxes(fixtures.WATER30_BOX, fixtures.WATER30_ORIGIN)
    center = 1.10
    b = tbias.HarmonicBias(cv=tbias.distance_cv(0, 1), k=2000.0,
                           center=center)
    sim = _port_sim(tpot, species, masses, b.force,
                    integrator=tint.Langevin(
                        temp=300.0, damp=20.0,
                        generator=torch.Generator().manual_seed(3)))
    st = sim.init_state(fixtures.WATER30_POS, tbox, temp=300.0, seed=3)
    st, _ = sim.run(st, 30)
    pos = sim.positions_input_order(st)
    assert abs(np.linalg.norm(pos[0] - pos[1]) - center) < 0.15
