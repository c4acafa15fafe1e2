"""The port's MD slice vs the JAX package: trajectory, derived
capacities, thermostat.

WATER30 replicated 2x2x2 (240 atoms, 16 A box), f64, skin 1.0 (the 3x3x3
fine roll grid needs it there), explicit caller-order velocities. The
JAX side runs its mirror engine — the plain reference the JAX package
holds its own roll engine against (tests/test_aev_pallas.py) — so the
port's roll engine is compared with an independent path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lammps_ani_tpu as jlat
import lammps_ani_torch as tlat
from lammps_ani_tpu.md import integrate as jint
from lammps_ani_tpu.models import zoo as jzoo
from lammps_ani_torch.md import integrate as tint
from lammps_ani_torch.models import zoo as tzoo

from .test_torch_neighbors import water_system

DT = 0.2

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: with several test processes on one machine, each
    with a thread per core, the threads wait on one another at every
    operation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _nbr(mod, **kw):
    return mod.NeighborConfig(cutoff=5.1, skin=1.0, k_max=160,
                              ghost_capacity=8192, rebuild_every=2, **kw)


@pytest.fixture(scope="module")
def system():
    species, pos, h, origin, masses = water_system(2)
    vel0 = 0.002 * np.random.default_rng(3).standard_normal(pos.shape)
    jpot = jzoo.ani2x(num_models=1, dtype=jnp.float64)
    tpot = tzoo.ani2x(num_models=1, dtype=torch.float64, device="cpu",
                      params=tzoo.params_from_numpy(
                          jax.tree.map(np.asarray, jpot.params)))
    return dict(species=species, pos=pos, h=h, origin=origin, masses=masses,
                vel0=vel0, jpot=jpot, tpot=tpot)


def _jax_box(s):
    return jlat.Box(h=jnp.asarray(s["h"]), origin=jnp.asarray(s["origin"]))


def _port_box(s):
    return tlat.Box(h=torch.tensor(s["h"]), origin=torch.tensor(s["origin"]))


def _port_sim(s, integrator=None, **nbr_kw):
    return tlat.Simulation(potential=s["tpot"], species=s["species"],
                           masses=s["masses"], nbr=_nbr(tlat, **nbr_kw),
                           dt=DT, dtype=torch.float64, integrator=integrator,
                           device="cpu", engine="pallas_full")


def _jax_mirror_run(s, n_steps, integrator=None):
    import os
    old = os.environ.get("LAT_ROLL_IMPL")
    os.environ["LAT_ROLL_IMPL"] = "mirror-off"
    try:
        sim = jlat.Simulation(potential=s["jpot"], species=s["species"],
                              masses=s["masses"], nbr=_nbr(jlat), dt=DT,
                              dtype=jnp.float64, integrator=integrator)
        st = sim.init_state(s["pos"], _jax_box(s), vel=s["vel0"], seed=11)
        st, rows = sim.run(st, n_steps, thermo_every=1)
    finally:
        if old is None:
            os.environ.pop("LAT_ROLL_IMPL")
        else:
            os.environ["LAT_ROLL_IMPL"] = old
    return sim, st, rows


@pytest.fixture(scope="module")
def nve(system):
    jsim, jst, jrows = _jax_mirror_run(system, 4)
    tsim = _port_sim(system)
    tst = tsim.init_state(system["pos"], _port_box(system),
                          vel=system["vel0"])
    tst, trows = tsim.run(tst, 4, thermo_every=1)
    return dict(jsim=jsim, jst=jst, jrows=jrows, tsim=tsim, tst=tst,
                trows=trows)


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
    """atol 1e-13 A/fs: both engines agree to f64 rounding (the port's
    CELU keeps the exact derivative, as JAX's does)."""
    np.testing.assert_allclose(nve["tsim"].velocities_input_order(nve["tst"]),
                               nve["jsim"].velocities_input_order(nve["jst"]),
                               atol=1e-13)


def test_port_forces_match_autograd_oracle(nve):
    """Port forces and virial after 4 steps vs torch.autograd through the
    generic AEV oracle (brute neighbor matrix + compute_aev + the same
    networks; virial from the same additive strain)."""
    from lammps_ani_torch import units
    from lammps_ani_torch.models import aev as taev
    from lammps_ani_torch.models import networks as tnet
    from lammps_ani_torch.ops import neighbors as tnb

    sim, st = nve["tsim"], nve["tst"]
    pot = sim.potential
    pos = st.pos.detach().clone().requires_grad_(True)
    eps = torch.zeros((3, 3), dtype=pos.dtype, requires_grad=True)
    ghosts = tnb.build_ghosts(st.pos, st.box, 5.1, 8192, tnb.image_shifts(1))
    nl = tnb.build_neighbor_matrix_brute(st.pos, st.box, 5.1, 128, ghosts)
    box = tnb.Box(h=st.box.h + st.box.h @ eps, origin=st.box.origin)
    diff, dist = tnb.neighbor_displacements(pos + pos @ eps, box, nl)
    sj = tnb.extended_species(sim.species, ghosts)[nl.idx]
    aev = taev.compute_aev(pot.spec.aev, sim.species, diff, dist, sj,
                           nl.mask & (sj >= 0), angular_capacity=48)
    e = tnet.ensemble_energies(tnet.atomic_energies_sorted(
        pot.spec.net, pot.params, sim.species_counts, aev)).sum()
    e = e + pot.spec.shifter(sim.species, dtype=e.dtype).sum()
    c = units.HARTREE2KCALMOL
    dpos, deps = torch.autograd.grad(e, (pos, eps))
    np.testing.assert_allclose(st.force.numpy(), -dpos.numpy() * c,
                               atol=1e-10)
    np.testing.assert_allclose(st.virial.numpy(),
                               -0.5 * (deps + deps.T).numpy() * c,
                               atol=1e-9, rtol=1e-12)
    np.testing.assert_allclose(float(st.pe), float(e.detach()) * c,
                               rtol=1e-12)


@pytest.mark.parametrize("key", ["pe", "ke", "etotal", "temp", "press",
                                 "vol", "density"])
def test_nve_thermo_rows_match_jax(nve, key):
    """rtol 1e-12: f64 rounding, summed in other orders."""
    assert [r["step"] for r in nve["trows"]] == [1, 2, 3, 4]
    np.testing.assert_allclose([r[key] for r in nve["trows"]],
                               [r[key] for r in nve["jrows"]],
                               rtol=1e-12, atol=1e-12)


def test_atom_order_matches_jax(nve):
    np.testing.assert_array_equal(nve["tsim"].order, nve["jsim"].order)


@pytest.mark.parametrize("use_cell_list", [False, True])
def test_derived_capacities_match_jax_roll_engine(system, monkeypatch,
                                                  use_cell_list):
    """Roll grid, cap, radial shell and angular caps as the JAX package's
    `pallas_full` engine derives them (its setup only; no kernels run)."""
    monkeypatch.setenv("LAT_ROLL_IMPL", "pallas_full")
    jsim = jlat.Simulation(potential=system["jpot"],
                           species=system["species"],
                           masses=system["masses"],
                           nbr=_nbr(jlat, use_cell_list=use_cell_list,
                                    cell_capacity=8),
                           dt=DT, dtype=jnp.float64, cellroll=True)
    jbox = _jax_box(system)
    jsim._spatial_sort(system["pos"], jbox)
    jpos = jnp.asarray(system["pos"][jsim.order])
    jsim._setup_grids(jpos, jbox)
    jsim._derive_angular_caps(jpos, jbox)

    tsim = _port_sim(system, use_cell_list=use_cell_list, cell_capacity=8)
    tsim.init_state(system["pos"], _port_box(system), vel=system["vel0"])
    assert tsim._roll_grid.ncells == jsim._roll_grid.ncells == (3, 3, 3)
    assert tsim._roll_grid.cap == jsim._roll_grid.cap
    assert tsim._roll_shell == jsim._roll_shell == 2
    assert (tsim.potential.spec.angular_caps
            == jsim.potential.spec.angular_caps)
    assert tsim._k_max == jsim._k_max
    if use_cell_list:
        assert tsim._grid.ncells == jsim._grid.ncells
        assert tsim._grid.cell_capacity == jsim._grid.cell_capacity


def test_langevin_force_formula_matches_jax():
    rng = np.random.default_rng(5)
    vel = 0.01 * rng.standard_normal((30, 3))
    masses = rng.uniform(1.0, 16.0, 30)
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(key, vel.shape, jnp.float64))
    ref = jint.Langevin(temp=300.0, damp=100.0).force(
        key, jnp.asarray(vel), jnp.asarray(masses), 0.5)
    got = tint.Langevin(temp=300.0, damp=100.0).force(
        torch.tensor(vel), torch.tensor(masses), 0.5,
        noise=torch.tensor(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13)


class _GivenNoise(tint.Langevin):
    """Langevin whose per-step normals are given (here: the JAX engine's)."""

    def __init__(self, noises):
        super().__init__(temp=300.0, damp=100.0)
        self.noises = list(noises)

    def noise(self, shape, dtype, device):
        return torch.tensor(self.noises.pop(0), dtype=dtype, device=device)


def test_langevin_step_matches_jax_with_same_noise(system):
    """One Langevin step of both engines fed the same noise: the JAX
    engine draws normal(split(key)[1]) in its internal atom order, which
    is the port's order too."""
    jsim, jst, _ = _jax_mirror_run(
        system, 1, integrator=jint.Langevin(temp=300.0, damp=100.0))
    _, sub = jax.random.split(jax.random.PRNGKey(11))
    noise = np.asarray(jax.random.normal(sub, system["pos"].shape,
                                         jnp.float64))
    tsim = _port_sim(system, integrator=_GivenNoise([noise]))
    tst = tsim.init_state(system["pos"], _port_box(system),
                          vel=system["vel0"])
    tst, _ = tsim.run(tst, 1)
    np.testing.assert_allclose(tsim.velocities_input_order(tst),
                               jsim.velocities_input_order(jst), atol=1e-9)
    np.testing.assert_allclose(tsim.positions_input_order(tst),
                               jsim.positions_input_order(jst), atol=1e-10)


def test_unported_options_raise(system):
    """RATTLE and extra_force are not ported yet; an integrator or a
    barostat of no ported kind is refused (every JAX ensemble is ported:
    tests/test_torch_npt.py)."""
    with pytest.raises(TypeError):
        _port_sim(system, integrator=object())
    kw = dict(potential=system["tpot"], species=system["species"],
              masses=system["masses"], nbr=_nbr(tlat), device="cpu")
    with pytest.raises(TypeError):
        tlat.Simulation(barostat=object(), **kw)
    with pytest.raises(NotImplementedError):
        tlat.Simulation(constraints=object(), **kw)
    with pytest.raises(NotImplementedError):
        tlat.Simulation(extra_force=lambda *a: None, **kw)
    small = dict(system, pos=water_system(1)[1], h=water_system(1)[2],
                 species=water_system(1)[0], masses=water_system(1)[4])
    # a box too small for the roll grid runs the mirror engine (it used to
    # raise): the JAX package's behaviour
    sim = _port_sim(small)
    state = sim.init_state(small["pos"], _port_box(small))
    assert sim.engine == "mirror" and bool(torch.isfinite(state.pe))
