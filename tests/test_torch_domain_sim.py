"""The port's sharded engine (lammps_ani_torch/parallel/sim.py,
`DomainSimulation` on the in-process mesh) against the port's single-device
`Simulation` on the CPU, f64, at the JAX package's own tolerances (F atol
1e-10, pe rtol 1e-12, W atol 1e-9; the cases of tests/test_parallel.py and
tests/test_parallel_asn.py) on WATER30 x 2^3 (240 atoms, a 16 A cube,
whose (2,2,2) bricks still hold rlist): the xla (mirror-ext) engine at
skin 2.0, the pallas_asn engine (the kernels' plain versions on the CPU)
at skin 1.0. Also migration, every regrow kind (in `run`, and the asn
kinds in `evaluate`), NPT, the restarts, the early-earth restart of
examples/, and the neighbor radius max(cutoff, Rcr) + skin held against
the JAX engine's cutoff + skin, which misses a pair.
"""

import dataclasses
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lammps_ani_torch as tlat
from lammps_ani_torch.io.lammps_data import LammpsData, replicate
from lammps_ani_torch.md import integrate
from lammps_ani_torch.models import zoo as tzoo
from lammps_ani_torch.ops.neighbors import Box, wrap_positions
from lammps_ani_torch.parallel import sim as psim
from lammps_ani_torch.parallel.domain import DomainSpec, auto_domain_spec
from lammps_ani_torch.parallel.sim import DomainSimulation

from .fixtures import MASSES, WATER30_POS, WATER30_SPECIES

F64 = torch.float64
EARLY = Path(__file__).parents[1] / "examples" / "early_earth"


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def water(rep):
    d = LammpsData(species=WATER30_SPECIES.astype(np.int64),
                   positions=WATER30_POS, masses_by_type=MASSES,
                   box_bounds=np.array([[-4.0, 4.0]] * 3), tilt=np.zeros(3))
    return replicate(d, rep, rep, rep)


def box_of(data):
    return Box(h=torch.tensor(data.box_h), origin=torch.tensor(
        data.box_origin))


POT = tzoo.ani2x(num_models=1, dtype=F64, device="cpu")
# (replicas, skin) of each engine's system
SYSTEM = {"xla": (2, 2.0), "pallas_asn": (2, 1.0)}


@functools.lru_cache(maxsize=None)
def single(engine, n_steps, integrator=None, dt=0.2, rebuild_every=2,
           by=0.0):
    """The single-device reference (the mirror engine) and its state;
    `by` as in `translated`."""
    rep, skin = SYSTEM[engine]
    data = water(rep)
    data = dataclasses.replace(data, positions=data.positions + by)
    sim = tlat.Simulation(
        potential=POT, species=data.species,
        masses=data.masses_by_type[data.species],
        nbr=tlat.NeighborConfig(cutoff=5.1, skin=skin, k_max=160,
                                ghost_capacity=8192,
                                rebuild_every=rebuild_every),
        dt=dt, integrator=integrator, dtype=F64, device="cpu")
    st = sim.init_state(data.positions, box_of(data),
                        vel=np.zeros_like(data.positions))
    if n_steps:
        st, _ = sim.run(st, n_steps)
    return sim, st


def domain(engine, mesh_shape, dt=0.2, integrator=None, dspec=None,
           vel=None, **kw):
    """The sharded engine and its state."""
    rep, skin = SYSTEM[engine]
    data = water(rep)
    if dspec is None:
        dspec = auto_domain_spec(data.n_atoms, data.box_h, mesh_shape,
                                 5.1 + skin, k_max=160)
    kw.setdefault("rebuild_every", 2)
    dsim = DomainSimulation(POT, dspec, cutoff=5.1, skin=skin, dt=dt,
                            integrator=integrator, dtype=F64, device="cpu",
                            engine=engine, **kw)
    st = dsim.init_state(data.species, data.masses_by_type[data.species],
                         data.positions, box_of(data),
                         vel=np.zeros_like(data.positions) if vel is None
                         else vel)
    assert dsim.engine == engine
    return dsim, st


def efw_close(dsim, dst, sim, st, f_tol=1e-10, w_tol=1e-9):
    np.testing.assert_allclose(dsim.gather(dst, "force"),
                               sim.forces_input_order(st), rtol=0,
                               atol=f_tol)
    assert float(dst.pe) == pytest.approx(float(st.pe), rel=1e-12)
    np.testing.assert_allclose(dst.virial.numpy(), st.virial.numpy(),
                               rtol=0, atol=w_tol)


def positions_close(dsim, dst, sim, st, data, tol=1e-9):
    box = box_of(data)
    w = lambda p: wrap_positions(torch.tensor(p), box).numpy()  # noqa: E731
    d = np.abs(w(sim.positions_input_order(st)) - w(dsim.gather(dst, "pos")))
    L = np.diag(data.box_h)
    assert np.minimum(d, L - d).max() < tol


def translated(dst, by=1.5):
    """The state with every atom moved by `by` A along each axis (the
    forces do not change): the atoms within `by` of a brick face cross it,
    and migrate at the next rebuild."""
    return dst.replace(pos=dst.pos + by)


def gids_once(dst, n):
    gid = dst.gid.numpy()
    return np.array_equal(np.sort(gid[gid >= 0]), np.arange(n))


CASES = [("xla", (1, 1, 1), None), ("xla", (2, 1, 1), None),
         ("xla", (2, 2, 2), None), ("pallas_asn", (1, 1, 1), None),
         ("pallas_asn", (2, 1, 1), None), ("pallas_asn", (2, 2, 2), None),
         ("pallas_asn", (2, 2, 2), "blocks")]


@pytest.mark.parametrize("engine,mesh_shape,stage", CASES)
def test_forces_match_single_device(engine, mesh_shape, stage):
    """One step from the system moved across the brick faces (so the
    rebuild migrates): forces, pe, virial, positions and velocities."""
    sim, st = single(engine, 1, by=1.5)
    dsim, dst = domain(engine, mesh_shape, pair_stage=stage)
    dst, _ = dsim.run(translated(dst), 1)
    efw_close(dsim, dst, sim, st)
    positions_close(dsim, dst, sim, st, water(SYSTEM[engine][0]))
    np.testing.assert_allclose(dsim.gather(dst, "vel"),
                               sim.velocities_input_order(st), rtol=0,
                               atol=1e-10)
    assert dsim.regrow_events == 0 and gids_once(dst, sim.n_atoms)



def test_mirror_force_backward_matches_autograd():
    """The mirror-ext tables' gather backward against plain autograd into
    the extended positions (`mirror_force=False`), at one evaluation."""
    sa, a = domain("xla", (2, 2, 1), mirror_force=False)
    sb, b = domain("xla", (2, 2, 1))
    a, b = sa.evaluate(a), sb.evaluate(b)
    assert b.pe.item() == pytest.approx(a.pe.item(), rel=1e-12)
    np.testing.assert_allclose(sb.gather(b, "force"), sa.gather(a, "force"),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(b.virial.numpy(), a.virial.numpy(), rtol=0,
                               atol=1e-9)

@pytest.mark.parametrize("engine,steps", [("xla", 4), ("pallas_asn", 1)])
def test_nve_trajectory_matches_single_device(engine, steps, monkeypatch):
    """NVE on (2,2,2), a rebuild every 2 steps, the system moved across
    the brick faces first so the first rebuild migrates; the asn engine
    with its two occupancy tiers forced on (the packed stage's one step
    without tiers is a case of `test_forces_match_single_device`)."""
    if engine == "pallas_asn":
        monkeypatch.setattr(psim, "ANG_TIER_MIN_N", 1)
    sim, st = single(engine, steps, by=1.5)
    dsim, dst = domain(engine, (2, 2, 2))
    if engine == "pallas_asn":
        assert dsim._tiers is not None
    gid0 = dst.gid.clone()
    dst, _ = dsim.run(translated(dst), steps)
    assert not torch.equal(dst.gid, gid0)
    positions_close(dsim, dst, sim, st, water(SYSTEM[engine][0]))
    np.testing.assert_allclose(dsim.gather(dst, "vel"),
                               sim.velocities_input_order(st), rtol=0,
                               atol=1e-10)
    efw_close(dsim, dst, sim, st)


def test_nose_hoover_matches_single_device():
    nh = integrate.NoseHoover(temp=300.0, tdamp=50.0)
    sim, st = single("xla", 4, integrator=nh)
    dsim, dst = domain("xla", (2, 2, 1), integrator=nh)
    dst, rows = dsim.run(dst, 4, thermo_every=2)
    np.testing.assert_allclose(dsim.gather(dst, "pos"),
                               sim.positions_input_order(st), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(dst.thermostat.eta_dot.numpy(),
                               st.thermostat.eta_dot.numpy(), rtol=1e-9)
    assert len(rows) == 2 and np.isfinite(rows[-1]["temp"])


@pytest.mark.parametrize("engine,mesh_shape,steps",
                         [("xla", (2, 2, 1), 2), ("pallas_asn", (2, 1, 1), 2)])
def test_npt_matches_single_device(engine, mesh_shape, steps):
    npt = integrate.NoseHooverNPT(temp=300.0, tdamp=50.0, press=1.0,
                                  pdamp=500.0)
    sim, st = single(engine, steps, integrator=npt)
    dsim, dst = domain(engine, mesh_shape, integrator=npt,
                       use_brick_cells=True)
    dst, rows = dsim.run(dst, steps, thermo_every=2)
    np.testing.assert_allclose(dst.box.h.numpy(), st.box.h.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(dsim.gather(dst, "pos"),
                               sim.positions_input_order(st), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(dsim.gather(dst, "vel"),
                               sim.velocities_input_order(st), rtol=0,
                               atol=1e-10)
    assert float(dst.barostat.omega) == pytest.approx(
        float(st.barostat.omega), rel=1e-9)
    assert np.isfinite(rows[-1]["press"])
    h = dst.box.h.numpy()
    if engine == "xla":
        # the frozen grid covers this box, not one half its size
        assert dsim._brick_grid is not None
        assert dsim._brick_grid_valid(h) and not dsim._brick_grid_valid(h / 2)
    else:
        assert dsim._asn_grid_valid(h) and not dsim._asn_grid_valid(h * 0.9)


def test_npt_rederives_the_brick_bins():
    """A box shrunk past the asn brick bins' slack: `run` re-derives them
    (one grid regrow) and the run goes on with the same forces as a fresh
    engine on that box."""
    npt = integrate.NoseHooverNPT(temp=300.0, tdamp=50.0, press=1.0,
                                  pdamp=500.0)
    dsim, dst = domain("pallas_asn", (1, 1, 1), integrator=npt)
    old = dsim._asn_grid
    dsim._asn_grid = dataclasses.replace(old, margin_frac=tuple(
        m * 0.9 for m in old.margin_frac))
    dst, _ = dsim.run(dst, 1)
    assert dsim.regrow_kinds["grid"] == 1 and dsim._asn_grid_valid(
        dst.box.h.numpy())
    assert dsim.engine == "pallas_asn" and gids_once(dst, 240)


def test_migration_keeps_every_atom():
    """Langevin at 400 K from a hot start (0.4 fs steps), the system first
    moved across the brick faces: atoms migrate, each `gid` stays exactly
    once."""
    vel = 0.02 * np.random.default_rng(2).standard_normal((240, 3))
    dsim, dst = domain("xla", (2, 2, 2), dt=0.4, vel=vel,
                       integrator=integrate.Langevin(
                           temp=400.0, damp=50.0,
                           generator=torch.Generator().manual_seed(3)))
    gid0 = dst.gid.clone()
    dst = translated(dst)
    for _ in range(2):
        dst, rows = dsim.run(dst, 2, thermo_every=2)
        assert gids_once(dst, 240) and np.isfinite(rows[-1]["etotal"])
    # atoms changed shards on the way
    assert not torch.equal(dst.gid, gid0)


def test_xla_regrows_undersized_capacities():
    """mig_cap 1, halo caps 16, k_max 32 and angular caps of 4: `run` grows
    each (never dies) and the run matches the single-device engine."""
    sim, st = single("xla", 2)
    data = water(2)
    dspec = DomainSpec(mesh_shape=(2, 2, 1), n_cap=128, halo_cap=(16, 16, 16),
                       mig_cap=1, k_max=32)
    dsim, dst = domain("xla", (2, 2, 1), dspec=dspec)
    dsim.potential = dsim.potential.with_spec(dataclasses.replace(
        dsim.potential.spec, angular_caps=(4, 0, 0, 4, 0, 0, 0)))
    dst, _ = dsim.run(dst, 2)
    kinds = dsim.regrow_kinds
    assert all(kinds[k] > 0 for k in ("halo", "k_max", "angular")), kinds
    assert dsim.dspec.k_max > 32 and min(dsim.dspec.halo_cap) > 16
    efw_close(dsim, dst, sim, st)
    positions_close(dsim, dst, sim, st, data)
    # migration: a hot start moves atoms across faces with one slot a way
    rng = np.random.default_rng(5)
    vel = 0.02 * rng.standard_normal((data.n_atoms, 3))
    dsim, dst = domain("xla", (2, 2, 1), dspec=dspec, vel=vel, dt=0.4)
    dst, _ = dsim.run(translated(dst), 4)
    assert dsim.regrow_kinds["mig"] > 0 and dsim.dspec.mig_cap > 1
    assert gids_once(dst, data.n_atoms)


def undersized_asn(monkeypatch):
    """The asn engine on (1,1,1) with the bin cap, the compact sections,
    the angular caps and the last tier's rows undersized (tiers forced
    on), and its state."""
    monkeypatch.setattr(psim, "ANG_TIER_MIN_N", 1)
    # 1,024 slots: more rows than two tiers of one row block (256) hold
    dspec = dataclasses.replace(auto_domain_spec(240, water(2).box_h,
                                                 (1, 1, 1), 6.1), n_cap=1024)
    dsim, dst = domain("pallas_asn", (1, 1, 1), dspec=dspec)
    assert dsim._tiers is not None
    dsim._asn_grid = dataclasses.replace(dsim._asn_grid, cap=8)
    dsim._sections = tuple((s, 8) for s, _ in dsim._sections)
    caps = tuple(4 if c else 0 for c in dsim.potential.spec.angular_caps)
    dsim.potential = dsim.potential.with_spec(dataclasses.replace(
        dsim.potential.spec, angular_caps=caps))
    # both tiers at one row (one row block): the rows tier 0 cannot take
    # spill to the last tier, which cannot take them all
    dsim._tiers = ((caps, 1), (caps, 1))
    return dsim, dst


def assert_asn_regrew(dsim):
    kinds = dsim.regrow_kinds
    assert all(kinds[k] > 0 for k in ("roll", "sections", "angular",
                                      "tier_rows")), kinds
    assert dsim._asn_grid.cap > 8 and all(
        c > 4 for c in dsim.potential.spec.angular_caps if c)


def test_asn_regrows_undersized_capacities(monkeypatch):
    """The bin cap, the compact sections, the angular caps and the last
    tier's rows undersized (tiers forced on): each grows, and the forces
    match the single-device engine."""
    sim, st = single("pallas_asn", 2)
    dsim, dst = undersized_asn(monkeypatch)
    dst, _ = dsim.run(dst, 2)
    assert_asn_regrew(dsim)
    efw_close(dsim, dst, sim, st)


def test_evaluate_regrows_undersized_asn_capacities(monkeypatch):
    """`evaluate` with the same capacities undersized: the rebuild's
    overflows and the force evaluation's deficits (an angular cap, the
    last tier's rows) each grow, and E/F/W match the single-device
    engine's at the input state, not a truncated sum."""
    sim, st = single("pallas_asn", 0)
    dsim, dst = undersized_asn(monkeypatch)
    dst = dsim.evaluate(dst)
    assert_asn_regrew(dsim)
    efw_close(dsim, dst, sim, st)


def test_recovers_from_a_skin_violation():
    """rebuild_every far too long for the skin: a chunk stops before the
    step that would leave skin/2, `run` rebuilds and still makes every
    step, on the trajectory of a rebuild every step."""
    rng = np.random.default_rng(5)
    vel = 0.05 * rng.standard_normal((240, 3))
    stops = []

    def run(rebuild_every):
        data = water(2)
        dspec = auto_domain_spec(240, data.box_h, (2, 1, 1), 5.45, k_max=160)
        dsim = DomainSimulation(POT, dspec, cutoff=5.1, skin=0.35,
                                rebuild_every=rebuild_every, dt=0.4,
                                dtype=F64, device="cpu", engine="xla")
        dst = dsim.init_state(data.species, data.masses_by_type[data.species],
                              data.positions, box_of(data), vel=vel)
        chunk = dsim._chunk

        def counted(state, take):
            out = chunk(state, take)
            stops.append(out[4] < take)
            return out

        dsim._chunk = counted
        dst, _ = dsim.run(dst, 4)
        assert dst.step == 4
        return dsim.gather(dst, "pos")

    p_long = run(4)
    assert any(stops)  # a chunk stopped early: the check fired
    np.testing.assert_allclose(p_long, run(1), rtol=0, atol=1e-9)


def test_brick_extent_error():
    data = water(2)
    dspec = auto_domain_spec(240, data.box_h, (4, 1, 1), 7.1)
    dsim = DomainSimulation(POT, dspec, cutoff=5.1, skin=2.0, dtype=F64,
                            device="cpu", engine="xla")
    with pytest.raises(ValueError, match="brick extent 4.00 A along dx"):
        dsim.init_state(data.species, data.masses_by_type[data.species],
                        data.positions, box_of(data))


def test_gather_and_restart_round_trip(tmp_path):
    """`gather` gives input order; a save/load round trip resumes bit for
    bit, and equals the run it continues (the file's `slot` gives back the
    layout, its metadata the sizing)."""
    nh = integrate.NoseHoover(temp=300.0, tdamp=50.0)
    dsim, dst = domain("xla", (2, 2, 1), integrator=nh)
    data = water(2)
    assert np.array_equal(dsim.gather(dst, "species"), data.species)
    np.testing.assert_allclose(
        dsim.gather(dst, "pos"),
        wrap_positions(torch.tensor(data.positions), box_of(data)).numpy(),
        rtol=0, atol=0)
    dst, _ = dsim.run(dst, 2)
    path = tmp_path / "r.npz"
    dsim.save_restart(path, dst)
    with np.load(path) as z:
        assert set(z.files) == {"pos", "vel", "species", "mass", "box_h",
                                "box_origin", "step", "ts_eta",
                                "ts_eta_dot", "slot", "__meta__"}
    cont, _ = dsim.run(dst, 2)
    dsim2, _ = domain("xla", (2, 2, 1), integrator=nh)
    dst2 = dsim2.load_restart(path)
    assert dst2.step == 2
    a, _ = dsim.run(dsim.load_restart(path), 2)
    b, _ = dsim2.run(dst2, 2)
    for st in (a, cont):
        assert np.array_equal(dsim.gather(st, "pos"), dsim2.gather(b, "pos"))
        assert np.array_equal(dsim.gather(st, "vel"), dsim2.gather(b, "vel"))


def test_loads_the_early_earth_restart():
    """The JAX `DomainSimulation` restart of examples/early_earth (49,000
    atoms, H/C/N/O, an 80.17 A cube) on mesh (2,2,2), sized as
    config_50k.json says (auto_spec, k_max 112, cutoff 5.1, skin 1.0)."""
    path = EARLY / "early_earth_50k.stage0.npz"
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
    pot = tzoo.ani1xnr(num_models=1, dtype=torch.float32, device="cpu")
    pot = pot.with_spec(dataclasses.replace(pot.spec,
                                            angular_caps=(24, 8, 4, 12)))
    dsim = DomainSimulation(
        pot, auto_domain_spec(49000, ref["box_h"], (2, 2, 2),
                              max(5.1, pot.spec.cutoff) + 1.0, k_max=112),
        cutoff=5.1, skin=1.0, rebuild_every=10, dt=0.25,
        integrator=integrate.NoseHoover(temp=300.0, tdamp=50.0),
        dtype=torch.float32, device="cpu", engine="xla",
        auto_angular_caps=False)
    dst = dsim.load_restart(path)
    assert dsim.n_global == 49000 and gids_once(dst, 49000)
    assert np.array_equal(dsim.gather(dst, "species"), ref["species"])
    assert np.array_equal(np.bincount(ref["species"]),
                          [33000, 2000, 1000, 13000])
    assert np.array_equal(dst.box.h.numpy(), ref["box_h"])
    assert dst.step == int(ref["step"])
    assert np.array_equal(dst.thermostat.eta.numpy(), ref["ts_eta"])
    assert np.array_equal(dsim.gather(dst, "vel"), ref["vel"])


def test_neighbor_radius_covers_rcr():
    """ANI-1xnr (Rcr 5.2) at cutoff 5.1, skin 1.0: two C atoms 6.12 A apart
    close to 5.17 A in 4 steps without a rebuild. The JAX engine's list
    (cutoff + skin = 6.1) never held the pair: its force on them stays 0.
    The port's radius max(cutoff, Rcr) + skin = 6.2 holds it: its run
    equals a fresh evaluation at the final positions."""
    import jax

    from lammps_ani_tpu.models import zoo as jzoo
    from lammps_ani_tpu.ops import neighbors as jnb
    from lammps_ani_tpu.parallel.domain import DomainSpec as JSpec
    from lammps_ani_tpu.parallel.sim import DomainSimulation as JDomain

    species = np.array([1, 1, 0, 0])
    masses = np.array([12.011, 12.011, 1.008, 1.008])
    pos = np.array([[7.0, 10.0, 10.0], [13.12, 10.0, 10.0],
                    [10.0, 2.0, 2.0], [10.0, 2.7, 2.0]])
    vel = np.zeros((4, 3))
    vel[0, 0], vel[1, 0] = 0.11875, -0.11875
    h, origin = np.eye(3) * 20.0, np.zeros(3)
    jpot = jzoo.ani1xnr(num_models=1, dtype=jnp.float64)
    tpot = tzoo.ani1xnr(num_models=1, dtype=F64, device="cpu",
                        params=tzoo.params_from_numpy(
                            jax.tree.map(np.asarray, jpot.params)))
    kw = dict(cutoff=5.1, skin=1.0, rebuild_every=100, dt=1.0)

    jd = JDomain(jpot, JSpec((1, 1, 1), 8, (16, 32, 64), 8, 16),
                 dtype=jnp.float64, devices=jax.devices()[:1], **kw)
    jst = jd.init_state(species, masses, pos,
                        jnb.Box(h=jnp.asarray(h), origin=jnp.asarray(origin)),
                        vel=vel)
    jst, _ = jd.run(jst, 4)
    jf = jd.gather(jst, "force")

    def trun(p, v, steps):
        d = DomainSimulation(tpot, DomainSpec((1, 1, 1), 8, (16, 32, 64), 8,
                                              16), dtype=F64, device="cpu",
                             engine="xla", **kw)
        st = d.init_state(species, masses, p,
                          Box(h=torch.tensor(h), origin=torch.tensor(origin)),
                          vel=v)
        st, _ = d.run(st, steps)
        return d, st

    d, tst = trun(pos, vel, 4)
    assert d.rlist == pytest.approx(6.2) and jd.rlist == pytest.approx(6.1)
    tp = d.gather(tst, "pos")
    assert 5.1 < np.linalg.norm(tp[1] - tp[0]) < 5.2
    assert np.abs(jd.gather(jst, "pos") - tp).max() < 1e-6
    d0, st0 = trun(tp, None, 0)
    fresh = d0.evaluate(st0)
    f0 = d0.gather(fresh, "force")
    # inside Rcr: a fresh evaluation feels the pair, the JAX run does not
    assert abs(f0[0, 0]) > 1e-4 and jf[0, 0] == 0.0
    assert float(tst.pe) == pytest.approx(float(fresh.pe), rel=1e-13)
    assert np.abs(d.gather(tst, "force") - f0).max() <= 1e-12


def test_asn_box_cotangent_is_exactly_zero_on_brick_bins():
    """On a brick's padded bins every wrapped window lane is an empty pad
    bin: the fused op's box cotangent is exactly 0 (the virial flows
    through the halo's shifts instead)."""
    from lammps_ani_torch.ops import aev_asn
    from lammps_ani_torch.parallel import domain as pdom

    dsim, dst = domain("pallas_asn", (2, 2, 2))
    payload, rb, _ = dsim._rebuild(dst)
    pos_ext = pdom.halo_positions(dsim.mesh, dsim.dspec, payload["pos"],
                                  dst.box, rb.plan)[0]
    h = dst.box.h.clone().requires_grad_(True)
    spec = dsim.potential.spec
    outs = aev_asn.aev_asn_fused(
        spec.aev, dsim._asn_grid.roll, rb.bins[0], rb.asn[0], pos_ext,
        Box(h=h, origin=dst.box.origin), dsim._sections, spec.angular_caps,
        n_out=dsim.dspec.n_cap)[:3]
    g = torch.Generator().manual_seed(4)
    loss = sum((o * torch.randn(o.shape, generator=g, dtype=o.dtype)).sum()
               for o in outs)
    (dh,) = torch.autograd.grad(loss, h)
    assert torch.count_nonzero(dh) == 0
