"""The port's IO and tools (lammps_ani_torch/io/, tools/) against the JAX
package's.

  * LAMMPS data: files written by JAX's `write_lammps_data` (triclinic,
    velocities, Hmrmass) and by the port's (the same, and bonds, which
    JAX's writer leaves out) read by both of the port's parsers (the
    Python oracle and the native one, `fast=True`) and by JAX's, to equal
    arrays; for data without bonds the port's writer gives JAX's bytes,
    and its round trip keeps every field to the digits written (10, the
    masses 9).
  * The three dump writers byte for byte against JAX's on the same frames
    (lammpstrj orthorhombic and triclinic, xyz, dcd with its cell);
    ThermoLog's file JAX's bytes, `read_thermo_yaml` and `read_dcd` as
    JAX's on them.
  * Restarts (WATER30, the mirror engine, f64, dt 0.1 fs, a rebuild every
    2 steps): 4 steps, a restart, then 4 more, against a fresh
    `Simulation` resumed from the file for 4 steps: positions, velocities,
    forces, pe and the chains bit for bit under NVE, NVT, NPT and Langevin
    (the generator's state carried in `rng`). A JAX restart (NVT) loads
    into the port's NVT engine with positions, velocities, box, step and
    the chain exact, and into its Langevin engine with a RuntimeWarning.
  * `read_pdb`, `detect_bonds`, `pdb_to_lammps_data`, `repartition` and
    `apply_hmr` against JAX's on WATER30.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lammps_ani_tpu as jlat
import lammps_ani_torch as tlat
from lammps_ani_tpu.io import dump as jdump
from lammps_ani_tpu.io import lammps_data as jld
from lammps_ani_tpu.io import restart as jrest
from lammps_ani_tpu.md import integrate as jint
from lammps_ani_tpu.tools import hmr as jhmr
from lammps_ani_tpu.tools import pdb as jpdb
from lammps_ani_torch.io import dump as tdump
from lammps_ani_torch.io import fastio
from lammps_ani_torch.io import lammps_data as tld
from lammps_ani_torch.io import restart as trest
from lammps_ani_torch.md import integrate as tint
from lammps_ani_torch.tools import hmr as thmr
from lammps_ani_torch.tools import pdb as tpdb

from . import fixtures
from .test_torch_mirror import _pots

SYMS = ["H", "C", "N", "O", "S", "F", "Cl"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def data_fields(d):
    return dict(species=d.species, positions=d.positions,
                masses_by_type=d.masses_by_type, box_bounds=d.box_bounds,
                tilt=d.tilt, velocities=d.velocities,
                per_atom_mass=d.per_atom_mass, bonds=d.bonds)


def assert_same_data(got, ref):
    g, r = data_fields(got), data_fields(ref)
    for k in g:
        if r[k] is None:
            assert g[k] is None, k
        else:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(r[k]).dtype, k


def water_data(cls, triclinic=True, bonds=False):
    rng = np.random.default_rng(5)
    n = 30
    b = None
    if bonds:
        b = np.array([(1, 3 * i, 3 * i + k) for i in range(10)
                      for k in (1, 2)], np.int64)
    return cls(species=fixtures.WATER30_SPECIES.copy(),
               positions=fixtures.WATER30_POS + 0.123456789e-3,
               masses_by_type=fixtures.MASSES.copy(),
               box_bounds=np.array([[-4.0, 4.0], [-4.1, 3.9], [-3.7, 4.3]]),
               tilt=(np.array([0.5, -0.25, 0.125]) if triclinic
                     else np.zeros(3)),
               velocities=0.01 * rng.standard_normal((n, 3)),
               per_atom_mass=fixtures.MASSES[fixtures.WATER30_SPECIES] * 1.5,
               **({"bonds": b} if bonds else {}))


def read_all(path):
    """The port's two parsers and JAX's Python parser on one file."""
    return (tld.read_lammps_data(path, fast=False),
            tld.read_lammps_data(path, fast=True),
            jld.read_lammps_data(path, fast=False))


@pytest.mark.parametrize("triclinic", [False, True])
def test_data_files_written_by_jax(tmp_path, triclinic):
    jd = water_data(jld.LammpsData, triclinic)
    jld.write_lammps_data(tmp_path / "j.data", jd, comment="c")
    td = water_data(tld.LammpsData, triclinic)
    tld.write_lammps_data(tmp_path / "t.data", td, comment="c")
    assert ((tmp_path / "t.data").read_bytes()
            == (tmp_path / "j.data").read_bytes())
    assert fastio.get_lib() is not None
    py, native, ref = read_all(tmp_path / "j.data")
    assert_same_data(py, ref)
    assert_same_data(native, ref)
    assert py.velocities is not None and py.per_atom_mass is not None
    np.testing.assert_array_equal(py.atom_masses, ref.atom_masses)
    np.testing.assert_array_equal(py.box_h, ref.box_h)
    np.testing.assert_array_equal(py.box_origin, ref.box_origin)


def test_writer_round_trip_with_bonds(tmp_path):
    td = water_data(tld.LammpsData, bonds=True)
    tld.write_lammps_data(tmp_path / "t.data", td)
    py, native, ref = read_all(tmp_path / "t.data")
    assert_same_data(py, ref)
    assert_same_data(native, ref)
    np.testing.assert_array_equal(py.bonds, td.bonds)
    np.testing.assert_array_equal(py.species, td.species)
    # written to 10 significant digits (the masses to 9)
    for k in ("positions", "velocities", "per_atom_mass", "box_bounds",
              "tilt", "masses_by_type"):
        np.testing.assert_allclose(getattr(py, k), getattr(td, k),
                                   rtol=5e-9 if k == "masses_by_type"
                                   else 5e-10, err_msg=k)


def test_replicate_carries_masses(tmp_path):
    td = water_data(tld.LammpsData)
    jd = water_data(jld.LammpsData)
    assert_same_data(tld.replicate(td, 2, 1, 3), jld.replicate(jd, 2, 1, 3))


def frames():
    rng = np.random.default_rng(9)
    pos = [fixtures.WATER30_POS + 0.01 * rng.standard_normal((30, 3))
           for _ in range(2)]
    tri = fixtures.WATER30_BOX + np.array([[0, 0, 0], [0.3, 0, 0],
                                           [-0.2, 0.1, 0]])
    return pos, tri


@pytest.mark.parametrize("kind", ["lammpstrj", "lammpstrj_tri", "xyz",
                                  "dcd"])
def test_dump_writers_byte_for_byte(tmp_path, kind):
    pos, tri = frames()
    box = tri if kind == "lammpstrj_tri" else fixtures.WATER30_BOX
    out = {}
    for name, mod in (("port", tdump), ("jax", jdump)):
        path = tmp_path / f"{name}.{kind}"
        if kind.startswith("lammpstrj"):
            w = mod.LammpsTrjWriter(path, SYMS)
        elif kind == "xyz":
            w = mod.XYZWriter(path, SYMS)
        else:
            w = mod.DCDWriter(path, 30, dt_fs=0.25, every=50)
        for step, p in zip((50, 100), pos):
            w.write_frame(step, p, fixtures.WATER30_SPECIES, box,
                          fixtures.WATER30_ORIGIN)
        w.close()
        out[name] = path.read_bytes()
    assert out["port"] == out["jax"]
    if kind == "dcd":
        got = tdump.read_dcd(tmp_path / "port.dcd")
        np.testing.assert_array_equal(got, jdump.read_dcd(tmp_path
                                                          / "jax.dcd"))
        assert got.shape == (2, 30, 3)
        np.testing.assert_array_equal(got[-1], pos[-1].astype(np.float32))


def test_thermo_log_and_reader(tmp_path):
    rows = [{"step": s, "pe": -1.5 * s, "ke": 0.25 + s, "etotal": -1.0,
             "temp": 300.0 + s / 3, "press": 1.0 / 7, "vol": 512.0,
             "density": 0.98} for s in (10, 20, 30)]
    for name, mod in (("port", tdump), ("jax", jdump)):
        log = mod.ThermoLog(tmp_path / f"{name}.yaml")
        for r in rows:
            log(r)
        log.close()
        assert log.rows == rows
    assert ((tmp_path / "port.yaml").read_bytes()
            == (tmp_path / "jax.yaml").read_bytes())
    cols = tdump.read_thermo_yaml(tmp_path / "port.yaml")
    assert cols == jdump.read_thermo_yaml(tmp_path / "port.yaml")
    assert cols["step"] == [10.0, 20.0, 30.0]
    assert cols["temp"] == [r["temp"] for r in rows]


# ---------------------------------------------------------------------------
# Restarts
# ---------------------------------------------------------------------------

NBR = dict(cutoff=5.1, skin=2.0, k_max=128, ghost_capacity=1024,
           rebuild_every=2)


def ensemble(mod, name, seed=7):
    if name == "nve":
        return None
    if name == "nvt":
        return mod.NoseHoover(temp=300.0, tdamp=20.0)
    if name == "npt":
        return mod.NoseHooverNPT(temp=300.0, tdamp=20.0, press=1.0,
                                 pdamp=100.0)
    return tint.Langevin(temp=300.0, damp=50.0,
                         generator=torch.Generator().manual_seed(seed))


def port_sim(name, tpot):
    return tlat.Simulation(
        potential=tpot, species=fixtures.WATER30_SPECIES,
        masses=fixtures.MASSES[fixtures.WATER30_SPECIES],
        nbr=tlat.NeighborConfig(**NBR), dt=0.1, dtype=torch.float64,
        integrator=ensemble(tint, name), device="cpu")


def water_box():
    return tlat.Box.from_lammps(-4.0, 4.0, -4.0, 4.0, -4.0, 4.0,
                                dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def pots():
    return _pots(False, caps=None)


@pytest.mark.parametrize("name", ["nve", "nvt", "npt", "langevin"])
def test_resume_bit_for_bit(tmp_path, pots, name):
    _, tpot = pots
    sim = port_sim(name, tpot)
    st = sim.init_state(fixtures.WATER30_POS, water_box(), temp=300.0,
                        seed=5)
    st, _ = sim.run(st, 4)
    trest.save_restart(tmp_path / "ck.npz", sim, st)
    st_cont, _ = sim.run(st, 4)

    # a fresh engine (the Langevin generator seeded otherwise)
    sim2 = port_sim(name, tpot)
    if name == "langevin":
        sim2.integrator.generator.manual_seed(99)
    st2 = trest.load_restart(tmp_path / "ck.npz", sim2)
    assert st2.step == st.step == 4
    np.testing.assert_array_equal(sim2.positions_input_order(st2),
                                  sim.positions_input_order(st))
    st2, _ = sim2.run(st2, 4)
    for f in ("positions", "velocities", "forces"):
        np.testing.assert_array_equal(
            getattr(sim2, f"{f}_input_order")(st2),
            getattr(sim, f"{f}_input_order")(st_cont), err_msg=f)
    assert float(st2.pe) == float(st_cont.pe)
    assert torch.equal(st2.box.h, st_cont.box.h)
    if st_cont.thermostat is not None:
        assert torch.equal(st2.thermostat.eta_dot, st_cont.thermostat.eta_dot)
    if st_cont.barostat is not None:
        assert torch.equal(st2.barostat.omega, st_cont.barostat.omega)


@pytest.fixture(scope="module")
def jax_restart(tmp_path_factory, pots):
    """A restart the JAX package wrote after 4 NVT steps, and its state."""
    jpot, _ = pots
    jsim = jlat.Simulation(
        potential=jpot, species=fixtures.WATER30_SPECIES,
        masses=fixtures.MASSES[fixtures.WATER30_SPECIES],
        nbr=jlat.NeighborConfig(**NBR), dt=0.1, dtype=jnp.float64,
        integrator=ensemble(jint, "nvt"))
    jst = jsim.init_state(fixtures.WATER30_POS, jlat.Box(
        h=jnp.asarray(fixtures.WATER30_BOX, jnp.float64),
        origin=jnp.asarray(fixtures.WATER30_ORIGIN, jnp.float64)),
        temp=300.0, seed=5)
    jst, _ = jsim.run(jst, 4)
    path = tmp_path_factory.mktemp("jax_restart") / "jax.npz"
    jrest.save_restart(path, jsim, jst)
    return path, jsim, jst


@pytest.mark.parametrize("name", ["nvt", "langevin"])
def test_jax_restart_loads(pots, jax_restart, name):
    """The JAX NVT restart into the port's NVT engine (the chain exact)
    and into its Langevin engine (the JAX key refused with a warning)."""
    _, tpot = pots
    path, jsim, jst = jax_restart
    sim = port_sim(name, tpot)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        st = trest.load_restart(path, sim)
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)]
    assert any("keeps its own generator" in m for m in msgs) == (
        name == "langevin")
    np.testing.assert_array_equal(sim.positions_input_order(st),
                                  jsim.positions_input_order(jst))
    np.testing.assert_array_equal(sim.velocities_input_order(st),
                                  jsim.velocities_input_order(jst))
    np.testing.assert_array_equal(st.box.h.numpy(), np.asarray(jst.box.h))
    assert st.step == int(jst.step) == 4
    if name == "nvt":
        np.testing.assert_array_equal(st.thermostat.eta.numpy(),
                                      np.asarray(jst.thermostat.eta))
        np.testing.assert_array_equal(st.thermostat.eta_dot.numpy(),
                                      np.asarray(jst.thermostat.eta_dot))
    st, rows = sim.run(st, 2, thermo_every=1)
    assert np.isfinite(rows[-1]["etotal"])


# ---------------------------------------------------------------------------
# Tools
# ---------------------------------------------------------------------------

def write_pdb(path, species, pos, box=None):
    lines = []
    if box is not None:
        lines.append("CRYST1%9.3f%9.3f%9.3f%7.2f%7.2f%7.2f P 1           1"
                     % (box[0], box[1], box[2], 90.0, 90.0, 90.0))
    for i, (s, p) in enumerate(zip(species, pos)):
        el = SYMS[s]
        lines.append("HETATM%5d %-4s HOH A%4d    %8.3f%8.3f%8.3f  1.00  0.00"
                     "          %2s" % (i + 1, el, i // 3 + 1, *p, el))
    path.write_text("\n".join(lines) + "\nEND\n")


@pytest.mark.parametrize("with_box", [False, True])
def test_pdb_bonds_and_hmr(tmp_path, with_box):
    box = (8.0, 8.0, 8.0) if with_box else None
    pos = fixtures.WATER30_POS - fixtures.WATER30_ORIGIN
    write_pdb(tmp_path / "w.pdb", fixtures.WATER30_SPECIES, pos, box)
    ts, tp, th = tpdb.read_pdb(tmp_path / "w.pdb")
    js, jp, jh = jpdb.read_pdb(tmp_path / "w.pdb")
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tp, jp)
    assert (th is None) == (jh is None) == (not with_box)
    if with_box:
        np.testing.assert_array_equal(th, jh)
    tb = tpdb.detect_bonds(ts, tp, th)
    assert tb == jpdb.detect_bonds(js, jp, jh) and len(tb) == 20
    td = tpdb.pdb_to_lammps_data(tmp_path / "w.pdb", tmp_path / "t.data",
                                 box_pad=2.0, with_bonds=True)
    jd = jpdb.pdb_to_lammps_data(tmp_path / "w.pdb", tmp_path / "j.data",
                                 box_pad=2.0, with_bonds=True)
    assert_same_data(td, jd)
    back = tld.read_lammps_data(tmp_path / "t.data")
    np.testing.assert_array_equal(back.bonds, td.bonds)
    for use_bonds in (False, True):
        tin = td if use_bonds else tld.LammpsData(
            td.species, td.positions, td.masses_by_type, td.box_bounds,
            td.tilt)
        jin = jd if use_bonds else jld.LammpsData(
            jd.species, jd.positions, jd.masses_by_type, jd.box_bounds,
            jd.tilt)
        got = thmr.apply_hmr(tin, 3.0)
        ref = jhmr.apply_hmr(jin, 3.0)
        np.testing.assert_array_equal(got.per_atom_mass, ref.per_atom_mass)
        assert got.per_atom_mass.sum() == pytest.approx(
            tin.atom_masses.sum(), rel=1e-14)
    np.testing.assert_array_equal(
        thmr.repartition(ts, fixtures.MASSES[ts], tb, 2.0),
        jhmr.repartition(js, fixtures.MASSES[js], tb, 2.0))
    with pytest.raises(ValueError, match="HMR factor too large"):
        thmr.repartition(ts, fixtures.MASSES[ts], tb, 12.0)
