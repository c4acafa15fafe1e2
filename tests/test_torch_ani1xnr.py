"""ANI-1xnr and model selection in the port (lammps_ani_torch/models/zoo.py,
networks.py, potential.py) against the JAX package, f64.

  * `zoo.ani1xnr`'s spec equals JAX's field by field: the ANI-1x AEV (4
    species, Rcr 5.2, zeta 32, 384 wide), ANI1X_HIDDEN, the ANI-1x
    self-energies, XTB repulsion for HCNO at cutoff 5.1 (smooth); and
    `all_models` names both factories.
  * The golden `ani1xnr_*` entries of tests/golden/water30_golden.npz
    (JAX's synthetic 2-model ensemble, carried across by
    `params_from_numpy`) through the port's generic path (a plain neighbor
    matrix) and its mirror path (mirror tables, the angular sub-list, the
    species-blocked AEV at caps H 24 / O 12), at tests/test_golden.py's
    tolerances: e rtol 1e-13, f atol 1e-11, w atol 1e-9.
  * NVT (NoseHoover 300 K, tdamp 20 fs) on `pallas_asn` (the plain
    versions of the main path's eight kernels at ANI-1xnr's constants: the
    integer power, 10 species-pair blocks, Rcr 5.2 beside the repulsion's
    5.1) against the JAX package's mirror engine, on WATER30 x 3^3 (810
    atoms) and on a CH4 + 2 O2 mixture (examples/combustion's placement,
    the port's `prepare_system.build(40)`: 360 atoms at 0.25 g/cm^3), one model, dt
    0.2 fs, a rebuild every 2 steps, explicit velocities, 2 steps: forces
    within 1e-12 of the largest, the virial within 5.8e-11 of its largest
    entry, pe rtol 1e-11, positions 1e-10 A, the chain rtol 1e-10.
  * `select_models` (the function and the method) against JAX's: the
    first k members, on the caller's device and in its dtype.
  * The mirror engine's neighbor matrix reaches Rcr + skin when the
    configured cutoff is below Rcr (NeighborConfig cutoff 5.1, the JAX
    CLI's default, against ANI-1xnr's 5.2; skin 1.0 = ang_skin): two C
    atoms at 6.12 A close to 5.17 A in 4 steps of 1 fs, each moving less
    than half the skin. The JAX engine's matrix (radius 6.1) misses the
    pair until its next rebuild: its force on the pair is 0 where a
    fresh evaluation at the same positions gives 1.04e-3 kcal/mol/A. The
    port's (radius 6.2) holds it: its pe equals the fresh evaluation's to
    rtol 1e-13 and its forces agree to 1e-12.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lammps_ani_tpu as jlat
import lammps_ani_torch as tlat
from lammps_ani_tpu.md import integrate as jint
from lammps_ani_tpu.models import networks as jnet
from lammps_ani_tpu.models import potential as jpotmod
from lammps_ani_tpu.models import zoo as jzoo
from lammps_ani_torch.examples.combustion import prepare_system
from lammps_ani_torch.md import integrate as tint
from lammps_ani_torch.models import networks as tnet
from lammps_ani_torch.models import potential as tpotmod
from lammps_ani_torch.models import zoo as tzoo
from lammps_ani_torch.ops import nbr_grad as tng
from lammps_ani_torch.ops import neighbors as tnb

from . import fixtures
from .test_torch_neighbors import water_system
from .test_torch_npt import states_close
from .test_torch_npt_asn import forces_close

GOLDEN = np.load(Path(__file__).parent / "golden" / "water30_golden.npz")
NBR = dict(cutoff=5.1, skin=2.0, ghost_capacity=8192, rebuild_every=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pots(num_models):
    """JAX's ani1xnr (f64) and the port's holding the same weights."""
    jpot = jzoo.ani1xnr(num_models=num_models, dtype=jnp.float64)
    tpot = tzoo.ani1xnr(num_models=num_models, dtype=torch.float64,
                        device="cpu", params=tzoo.params_from_numpy(
                            jax.tree.map(np.asarray, jpot.params)))
    return jpot, tpot


def mixture(n_ch4=40):
    """examples/combustion's CH4 + 2 O2 placement (species H 0, C 1, O 3),
    as the port's `prepare_system.build` makes it."""
    return prepare_system.build(n_ch4)


def test_spec_matches_jax():
    jspec = jzoo.ani1xnr(num_models=1).spec
    tspec = tzoo.ani1xnr(num_models=1, device="cpu").spec
    assert dataclasses.asdict(tspec.aev) == dataclasses.asdict(jspec.aev)
    assert tspec.aev.aev_length == 384 and tspec.aev.num_species == 4
    assert tspec.aev.radial_cutoff == 5.2 and tspec.aev.zeta == (32.0,)
    assert tspec.net.hidden == jspec.net.hidden == tnet.ANI1X_HIDDEN
    assert tspec.net.aev_length == jspec.net.aev_length
    assert (tspec.shifter.self_energies == jspec.shifter.self_energies
            == tnet.ANI1X_SELF_ENERGIES == jnet.ANI1X_SELF_ENERGIES)
    for f in ("alpha", "zeff", "cutoff", "k_f", "cutoff_fn"):
        assert getattr(tspec.repulsion, f) == getattr(jspec.repulsion, f)
    assert tspec.repulsion.cutoff == 5.1
    assert tspec.symbols == jspec.symbols == tzoo.ANI1X_SYMBOLS
    assert set(tzoo.all_models) == set(jzoo.all_models)
    assert tzoo.all_models["ani1x_nr"] is tzoo.ani1xnr


@pytest.fixture(scope="module")
def water30():
    """WATER30 in its 8 A box, wrapped, with a 7.1 A neighbor matrix."""
    box = tnb.Box(h=torch.tensor(fixtures.WATER30_BOX, dtype=torch.float64),
                  origin=torch.tensor(fixtures.WATER30_ORIGIN,
                                      dtype=torch.float64))
    pos = tnb.wrap_positions(torch.tensor(fixtures.WATER30_POS,
                                          dtype=torch.float64), box)
    sp = torch.as_tensor(fixtures.WATER30_SPECIES).long()
    ghosts = tnb.build_ghosts(pos, box, 7.1, 1024, tnb.image_shifts(1))
    nlist = tnb.build_neighbor_matrix_brute(pos, box, 7.1, 128, ghosts)
    return sp, pos, box, nlist


@pytest.mark.parametrize("path", ["generic", "mirror"])
def test_golden(water30, path):
    _, tpot = pots(2)
    sp, pos, box, nlist = water30
    if path == "generic":
        e, f, w = tpotmod.energy_forces_virial(tpot, sp, pos, box, nlist)
    else:
        tpot = tpot.with_spec(dataclasses.replace(tpot.spec,
                                                  angular_caps=(24, 0, 0, 12)))
        nbrs = tng.mirror_neighbors(
            nlist, 30, pos=pos, box=box,
            ang_cutoff=tpot.spec.aev.angular_cutoff + 1.0, ang_cap=32,
            species=sp)
        assert bool(nbrs.ok)
        e, f, w = tpotmod.energy_forces_virial_mirror(tpot, sp, pos, box,
                                                      nbrs)
    np.testing.assert_allclose(float(e), float(GOLDEN["ani1xnr_e"]),
                               rtol=1e-13)
    np.testing.assert_allclose(f.detach().numpy(), GOLDEN["ani1xnr_f"],
                               atol=1e-11)
    np.testing.assert_allclose(w.detach().numpy(), GOLDEN["ani1xnr_w"],
                               atol=1e-9)


def system(name):
    if name == "water810":
        species, pos, h, origin, masses = water_system(3)
    else:
        d = mixture()
        species, pos, h, origin = (d.species, d.positions, d.box_h,
                                   d.box_origin)
        masses = d.masses_by_type[species]
    return dict(species=species, pos=pos, h=h, origin=origin, masses=masses,
                vel0=0.002 * np.random.default_rng(3).standard_normal(
                    pos.shape))


@pytest.mark.parametrize("name", ["water810", "mixture360"])
def test_nvt_asn_matches_jax_mirror(name):
    s = system(name)
    jpot, tpot = pots(1)
    kw = dict(species=s["species"], masses=s["masses"], dt=0.2)
    jsim = jlat.Simulation(potential=jpot, nbr=jlat.NeighborConfig(**NBR),
                           dtype=jnp.float64, integrator=jint.NoseHoover(
                               temp=300.0, tdamp=20.0), **kw)
    jst = jsim.init_state(s["pos"], jlat.Box(h=jnp.asarray(s["h"]),
                                             origin=jnp.asarray(s["origin"])),
                          vel=s["vel0"])
    jst, _ = jsim.run(jst, 2)
    tsim = tlat.Simulation(potential=tpot, nbr=tlat.NeighborConfig(**NBR),
                           dtype=torch.float64, device="cpu",
                           engine="pallas_asn", integrator=tint.NoseHoover(
                               temp=300.0, tdamp=20.0), **kw)
    tst = tsim.init_state(s["pos"], tlat.Box(h=torch.tensor(s["h"]),
                                             origin=torch.tensor(s["origin"])),
                          vel=s["vel0"])
    tst, _ = tsim.run(tst, 2)
    assert tsim.engine == "pallas_asn" and tsim.regrow_events == 0
    # one section per present species, over ANI-1xnr's 4
    present = sorted(set(int(x) for x in s["species"]))
    assert [sp for sp, _ in tsim._sections] == present
    assert len(tsim.potential.spec.angular_caps) == 4
    states_close(jsim, jst, tsim, tst, 1e-10, 1e-10)
    assert float(tst.pe) == pytest.approx(float(jst.pe), rel=1e-11)
    forces_close(jsim, jst, tsim, tst)


@pytest.fixture(scope="module")
def pots4():
    return pots(4)


@pytest.mark.parametrize("k", [None, 1, 3])
def test_select_models_matches_jax(pots4, k):
    jpot, tpot = pots4
    jsel = jnet.select_models(jpot.params, k)
    tsel = tnet.select_models(tpot.params, k)
    for jl, tl in zip(jax.tree.leaves(jsel),
                      [v for layers in tsel for layer in layers
                       for v in (layer["b"], layer["w"])]):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    sub = tpot.select_models(k)
    assert isinstance(sub, tpotmod.ANIPotential) and sub is not tpot
    assert sub.num_models == jpot.select_models(k).num_models
    assert sub.spec == tpot.spec
    assert all(v.dtype == torch.float64 and v.device.type == "cpu"
               for layers in sub.params for layer in layers
               for v in layer.values())
    assert isinstance(jpot.select_models(k), jpotmod.ANIPotential)


def test_neighbor_radius_covers_rcr():
    jpot, tpot = pots(1)
    species = np.array([1, 1, 0, 0])
    masses = np.array([12.011, 12.011, 1.008, 1.008])
    pos = np.array([[7.0, 10.0, 10.0], [13.12, 10.0, 10.0],
                    [10.0, 2.0, 2.0], [10.0, 2.7, 2.0]])
    vel = np.zeros((4, 3))
    vel[0, 0], vel[1, 0] = 0.11875, -0.11875
    h, origin = np.eye(3) * 20.0, np.zeros(3)
    nbr = dict(cutoff=5.1, skin=1.0, ang_skin=1.0, k_max=16,
               ghost_capacity=64, rebuild_every=100)

    def jrun(p, v, steps):
        sim = jlat.Simulation(potential=jpot, species=species, masses=masses,
                              nbr=jlat.NeighborConfig(**nbr), dt=1.0,
                              dtype=jnp.float64)
        st = sim.init_state(p, jlat.Box(h=jnp.asarray(h),
                                        origin=jnp.asarray(origin)), vel=v)
        st, _ = sim.run(st, steps)
        return (sim.positions_input_order(st), float(st.pe),
                np.asarray(st.force)[sim.inv_order])

    def trun(p, v, steps):
        sim = tlat.Simulation(potential=tpot, species=species, masses=masses,
                              nbr=tlat.NeighborConfig(**nbr), dt=1.0,
                              dtype=torch.float64, device="cpu")
        st = sim.init_state(p, tlat.Box(h=torch.tensor(h),
                                        origin=torch.tensor(origin)), vel=v)
        st, _ = sim.run(st, steps)
        return sim.positions_input_order(st), float(st.pe), \
            sim.forces_input_order(st)

    jp, je, jf = jrun(pos, vel, 4)
    tp, te, tf = trun(pos, vel, 4)
    assert 5.1 < np.linalg.norm(tp[1] - tp[0]) < 5.2
    assert np.abs(jp - tp).max() < 1e-6
    _, te0, tf0 = trun(tp, None, 0)
    # the pair is inside Rcr: a fresh evaluation feels it, JAX's run not
    assert abs(tf0[0, 0]) > 1e-4 and jf[0, 0] == 0.0
    assert te == pytest.approx(te0, rel=1e-13)
    assert np.abs(tf - tf0).max() <= 1e-12
