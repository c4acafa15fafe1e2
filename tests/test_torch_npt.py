"""The nvt and npt ensembles of the port (lammps_ani_torch/md/integrate.py,
md/state.py, md/simulation.py) against the JAX package, f64.

Units: every ported function of integrate.py on the same seeded numpy
inputs as its JAX counterpart, to 1e-13 relative: the Nose-Hoover chain's
half step (loops 1 and 2, with and without a given ke2), the piston's half
step (with and without dof), the velocity and box factors, the Berendsen
factor inside and at both clips, rescale_box, recenter, zero_momentum and
the mask= paths of kinetic_energy, temperature and pressure_tensor.
create_velocities with a mask draws other normals than JAX, so its
properties are checked: the exact temperature, zero momentum over the
masked atoms, zeros outside.

The ideal-gas piston of tests/test_features.py on the port's functions:
free particles under the MTK piston settle the pressure at the target
(5%) and the volume at N kB T / P (5%), as the JAX test asks.

Engine level: WATER30 (30 atoms, 8 A box, the mirror engine: no roll
grid fits), dt 0.1 fs, a rebuild every 2 steps, explicit velocities, 8
steps under NoseHoover, NoseHooverNPT and NVE + BerendsenBarostat, the
port's `Simulation` against the JAX `Simulation`: pe, box.h, the chain
(eta, eta_dot) and the piston (omega) to rtol 1e-10, positions to 1e-10
A (measured: at most 5e-15 A in the positions, the rest equal or within
1e-18 absolute).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lammps_ani_tpu as jlat
import lammps_ani_torch as tlat
from lammps_ani_tpu import units as junits
from lammps_ani_tpu.md import integrate as jint
from lammps_ani_tpu.md import state as jstate
from lammps_ani_torch import units as tunits
from lammps_ani_torch.md import integrate as tint
from lammps_ani_torch.md import state as tstate

from .test_torch_mirror import _pots
from .test_torch_neighbors import water_system

RTOL = 1e-13


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert np.abs(np.asarray(got) - ref).max() <= rtol * scale, (got, ref)


def t(x):
    return torch.tensor(np.asarray(x))


def j(x):
    return jnp.asarray(np.asarray(x))


@pytest.fixture(scope="module")
def atoms():
    rng = np.random.default_rng(11)
    n = 40
    return dict(vel=0.01 * rng.standard_normal((n, 3)),
                masses=rng.uniform(1.0, 16.0, n),
                mask=rng.uniform(size=n) < 0.6,
                virial=rng.standard_normal((3, 3)) * 50.0,
                pos=rng.uniform(-5.0, 5.0, (n, 3)),
                chain=(rng.standard_normal(3) * 0.1,
                       rng.standard_normal(3) * 0.02),
                omega=1e-4, omega_chain=(rng.standard_normal(3) * 0.1,
                                         rng.standard_normal(3) * 0.02))


def test_masked_thermo_functions(atoms):
    a = atoms
    for mask in (None, a["mask"]):
        jm = None if mask is None else j(mask)
        tm = None if mask is None else t(mask)
        close(tint.kinetic_energy(t(a["vel"]), t(a["masses"]), tm),
              jint.kinetic_energy(j(a["vel"]), j(a["masses"]), jm))
        close(tint.temperature(t(a["vel"]), t(a["masses"]), 87, tm),
              jint.temperature(j(a["vel"]), j(a["masses"]), 87, jm))
        close(tint.pressure_tensor(t(a["vel"]), t(a["masses"]),
                                   t(a["virial"]), 1234.5, tm),
              jint.pressure_tensor(j(a["vel"]), j(a["masses"]),
                                   j(a["virial"]), 1234.5, jm))
        close(tint.zero_momentum(t(a["vel"]), t(a["masses"]), tm),
              jint.zero_momentum(j(a["vel"]), j(a["masses"]), jm))
    close(tint.recenter(t(a["pos"]), t(a["masses"]), t([1.0, -2.0, 0.5])),
          jint.recenter(j(a["pos"]), j(a["masses"]), j([1.0, -2.0, 0.5])))


def test_create_velocities_with_mask(atoms):
    """The exact temperature over the masked atoms' dof, zero momentum
    over them, zeros outside."""
    m = t(atoms["mask"])
    masses = t(atoms["masses"])
    dof = 3 * int(m.sum()) - 3
    g = torch.Generator().manual_seed(5)
    vel = tint.create_velocities(g, masses, 300.0, dof, mask=m)
    assert not bool(vel[~m].any())
    assert float(tint.temperature(vel, masses, dof, m)) == pytest.approx(
        300.0, rel=1e-13)
    p = torch.sum(masses[:, None] * vel, dim=0)
    assert float(p.abs().max()) <= 1e-15 * float(
        (masses[:, None] * vel).abs().sum())


@pytest.mark.parametrize("loops", [1, 2])
@pytest.mark.parametrize("given_ke2", [False, True])
def test_nose_hoover_half_step(atoms, loops, given_ke2):
    a = atoms
    jnh = jint.NoseHoover(temp=300.0, tdamp=20.0, loops=loops)
    tnh = tint.NoseHoover(temp=300.0, tdamp=20.0, loops=loops)
    eta, eta_dot = a["chain"]
    jts = jstate.ThermostatState(eta=j(eta), eta_dot=j(eta_dot))
    tts = tstate.ThermostatState(eta=t(eta), eta_dot=t(eta_dot))
    ke2 = 0.37 if given_ke2 else None
    for _ in range(3):
        jts, jv = jnh.half_step(jts, j(a["vel"]), j(a["masses"]), 117,
                                jnp.asarray(0.5), ke2=ke2)
        tts, tv = tnh.half_step(tts, t(a["vel"]), t(a["masses"]), 117, 0.5,
                                ke2=ke2)
        close(tv, jv)
        close(tts.eta, jts.eta)
        close(tts.eta_dot, jts.eta_dot)
    assert tnh.masses_q(117) == jnh.masses_q(117)


@pytest.mark.parametrize("dof", [None, 90.0])
def test_piston_half_and_factors(atoms, dof):
    jnpt = jint.NoseHooverNPT(temp=300.0, tdamp=100.0, press=1.0,
                              pdamp=500.0)
    tnpt = tint.NoseHooverNPT(temp=300.0, tdamp=100.0, press=1.0,
                              pdamp=500.0)
    eta, eta_dot = atoms["omega_chain"]
    jbs = jstate.BarostatState(
        omega=j(atoms["omega"]),
        omega_chain=jstate.ThermostatState(eta=j(eta), eta_dot=j(eta_dot)))
    tbs = tstate.BarostatState(
        omega=t(atoms["omega"]),
        omega_chain=tstate.ThermostatState(eta=t(eta), eta_dot=t(eta_dot)))
    for p_now, vol, ke in ((350.0, 27000.0, 40.0), (-120.0, 26000.0, 42.0)):
        jbs = jnpt.piston_half(jbs, j(p_now), j(vol), j(ke), 30,
                               jnp.asarray(0.5), dof)
        tbs = tnpt.piston_half(tbs, t(p_now), t(vol), t(ke), 30, 0.5, dof)
        close(tbs.omega, jbs.omega)
        close(tbs.omega_chain.eta, jbs.omega_chain.eta)
        close(tbs.omega_chain.eta_dot, jbs.omega_chain.eta_dot)
    close(tnpt.vel_scale(tbs.omega, 87, 30, 0.5),
          jnpt.vel_scale(jbs.omega, 87, 30, jnp.asarray(0.5)))
    close(tnpt.box_scale(tbs.omega, 0.5),
          jnpt.box_scale(jbs.omega, jnp.asarray(0.5)))
    assert tnpt.piston_mass(30) == jnpt.piston_mass(30)
    ts, bs = tnpt.thermostat.init(torch.float64), tnpt.init(torch.float64)
    assert ts.eta.shape == (3,) and bs.omega.shape == ()
    assert tnpt.thermostat == tint.NoseHoover(temp=300.0, tdamp=100.0)


def test_berendsen_and_rescale_box():
    """Inside the clip, and at both of its ends (the volume factor held to
    [0.9, 1.1])."""
    jb = jint.BerendsenBarostat(press=1.0, pdamp=100.0)
    tb = tint.BerendsenBarostat(press=1.0, pdamp=100.0)
    for p_now in (500.0, -800.0, 1e7, -1e7):
        close(tb.scale_factor(t(p_now), 0.5),
              jb.scale_factor(j(p_now), jnp.asarray(0.5)))
    assert float(tb.scale_factor(t(1e7), 0.5)) == pytest.approx(
        1.1 ** (1 / 3), rel=1e-15)
    assert float(tb.scale_factor(t(-1e7), 0.5)) == pytest.approx(
        0.9 ** (1 / 3), rel=1e-15)
    h = np.diag([10.0, 11.0, 12.0]) + 0.3
    tbox = tint.rescale_box(tlat.Box(h=t(h), origin=t([1.0, 2.0, 3.0])),
                            t(1.01))
    jbox = jint.rescale_box(jlat.Box(h=j(h), origin=j([1.0, 2.0, 3.0])),
                            j(1.01))
    close(tbox.h, jbox.h)
    close(tbox.origin, jbox.origin)


def test_npt_piston_ideal_gas_volume():
    """tests/test_features.py's ideal gas on the port: free particles and
    the NH piston relax V toward N kB T / P. The same 6000 steps of 2 fs
    and limits (pressure and the ideal-gas volume within 5% over the last
    half); the velocities are the port's own draw."""
    n = 400
    t_target, p_target = 300.0, 500.0
    npt = tint.NoseHooverNPT(temp=t_target, tdamp=100.0, press=p_target,
                             pdamp=500.0)
    masses = torch.full((n,), 20.0, dtype=torch.float64)
    vel = tint.create_velocities(torch.Generator().manual_seed(0), masses,
                                 t_target, 3 * n)
    v_eq = n * tunits.BOLTZ * t_target / (p_target * tunits.ATM2ENGVOL)
    vol0 = 0.4 * v_eq
    vol = torch.tensor(vol0, dtype=torch.float64)
    bs = npt.init(torch.float64)
    dt = 2.0
    vols, ps, ts = [], [], []
    for _ in range(6000):
        ke = tint.kinetic_energy(vel, masses)
        p_now = 2.0 * ke / (3.0 * vol) * tunits.NKTV2P
        bs = npt.piston_half(bs, p_now, vol, ke, n, dt)
        vel = vel * npt.vel_scale(bs.omega, 3 * n, n, dt) ** 2
        vol = vol * npt.box_scale(bs.omega, dt) ** 3
        ke = tint.kinetic_energy(vel, masses)
        p_now = 2.0 * ke / (3.0 * vol) * tunits.NKTV2P
        bs = npt.piston_half(bs, p_now, vol, ke, n, dt)
        vols.append(vol)
        ps.append(p_now)
        ts.append(tint.temperature(vel, masses, 3 * n))
    p_avg = float(torch.stack(ps[3000:]).mean())
    t_avg = float(torch.stack(ts[3000:]).mean())
    v_avg = float(torch.stack(vols[3000:]).mean())
    assert abs(p_avg - p_target) / p_target < 0.05, p_avg
    v_consistent = n * tunits.BOLTZ * t_avg / (p_target * tunits.ATM2ENGVOL)
    assert abs(v_avg - v_consistent) / v_consistent < 0.05
    assert v_avg > 1.3 * vol0
    assert tunits.ATM2ENGVOL == junits.ATM2ENGVOL


# ---------------------------------------------------------------------------
# Engine level: WATER30 on the mirror engine
# ---------------------------------------------------------------------------

ENSEMBLES = {
    "nvt": lambda m: dict(integrator=m.NoseHoover(temp=300.0, tdamp=20.0)),
    "npt": lambda m: dict(integrator=m.NoseHooverNPT(
        temp=300.0, tdamp=20.0, press=1.0, pdamp=100.0)),
    "berendsen": lambda m: dict(barostat=m.BerendsenBarostat(
        press=1.0, pdamp=100.0)),
}


def run_pair(s, ensemble, n_steps, dt, nbr_kw, engine=None, stage=None,
             jsteps=None):
    """The JAX `Simulation` (its default mirror engine) and the port's
    (`engine`, `stage`) under `ensemble` from the same state, n_steps each
    (`jsteps`: the JAX run given, not run again)."""
    jpot, tpot = _pots(False, caps=None)
    kw = dict(species=s["species"], masses=s["masses"], dt=dt)
    if jsteps is None:
        jsim = jlat.Simulation(potential=jpot, nbr=jlat.NeighborConfig(
            **nbr_kw), dtype=jnp.float64, **ENSEMBLES[ensemble](jint), **kw)
        jst = jsim.init_state(s["pos"], jlat.Box(
            h=jnp.asarray(s["h"]), origin=jnp.asarray(s["origin"])),
            vel=s["vel0"])
        jst, _ = jsim.run(jst, n_steps)
        jsteps = (jsim, jst)
    tsim = tlat.Simulation(potential=tpot, nbr=tlat.NeighborConfig(
        **nbr_kw), dtype=torch.float64, device="cpu", engine=engine,
        pair_stage=stage, **ENSEMBLES[ensemble](tint), **kw)
    tst = tsim.init_state(s["pos"], tlat.Box(h=torch.tensor(s["h"]),
                                             origin=torch.tensor(
                                                 s["origin"])),
                          vel=s["vel0"])
    tst, rows = tsim.run(tst, n_steps, thermo_every=1)
    return (*jsteps, tsim, tst, rows)


def states_close(jsim, jst, tsim, tst, rtol, pos_atol):
    """pe, positions, box.h and the chain and piston states."""
    assert float(tst.pe) == pytest.approx(float(jst.pe), rel=rtol)
    np.testing.assert_allclose(tsim.positions_input_order(tst),
                               jsim.positions_input_order(jst), rtol=0,
                               atol=pos_atol)
    np.testing.assert_allclose(tst.box.h.numpy(), np.asarray(jst.box.h),
                               rtol=rtol, atol=0)
    for tpart, jpart in ((tst.thermostat, jst.thermostat),
                         (tst.barostat, jst.barostat)):
        assert (tpart is None) == (jpart is None)
    if tst.thermostat is not None:
        for f in ("eta", "eta_dot"):
            close(getattr(tst.thermostat, f), getattr(jst.thermostat, f),
                  rtol)
    if tst.barostat is not None:
        close(tst.barostat.omega, jst.barostat.omega, rtol)
        close(tst.barostat.omega_chain.eta_dot,
              jst.barostat.omega_chain.eta_dot, rtol)


@pytest.fixture(scope="module")
def water30():
    species, pos, h, origin, masses = water_system(1)
    return dict(species=species, pos=pos, h=h, origin=origin,
                masses=masses,
                vel0=0.002 * np.random.default_rng(3).standard_normal(
                    pos.shape))


@pytest.mark.parametrize("ensemble", sorted(ENSEMBLES))
def test_simulation_matches_jax(water30, ensemble):
    jsim, jst, tsim, tst, rows = run_pair(
        water30, ensemble, 8, 0.1,
        dict(cutoff=5.1, skin=2.0, k_max=128, ghost_capacity=1024,
             rebuild_every=2))
    assert tsim.engine == "mirror" and tst.step == 8
    states_close(jsim, jst, tsim, tst, 1e-10, 1e-10)
    if ensemble != "nvt":
        assert not np.allclose(tst.box.h.numpy(), water30["h"])
        assert rows[-1]["vol"] == pytest.approx(float(tst.box.volume))


def test_construction():
    """A barostat beside NoseHooverNPT raises JAX's ValueError; a barostat
    is active with NoseHooverNPT or a BerendsenBarostat beside any other
    integrator."""
    _, tpot = _pots(False, caps=None)
    species, _, _, _, masses = water_system(1)
    kw = dict(potential=tpot, species=species, masses=masses,
              nbr=tlat.NeighborConfig(cutoff=5.1), device="cpu")
    npt = tint.NoseHooverNPT(temp=300.0, tdamp=100.0, press=1.0, pdamp=500.0)
    with pytest.raises(ValueError, match="already includes a barostat"):
        tlat.Simulation(integrator=npt, barostat=tint.BerendsenBarostat(
            press=1.0, pdamp=100.0), **kw)
    sim = tlat.Simulation(integrator=tint.Langevin(300.0, 100.0),
                          barostat=tint.BerendsenBarostat(1.0, 100.0), **kw)
    assert sim._barostat_active()
    assert tlat.Simulation(integrator=npt, **kw)._barostat_active()
    assert not tlat.Simulation(integrator=tint.NoseHoover(300.0, 100.0),
                               **kw)._barostat_active()
