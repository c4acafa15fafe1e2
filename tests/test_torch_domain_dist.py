"""`DomainSimulation` (lammps_ani_torch/parallel/sim.py) on the process
group, one shard a rank over gloo on the CPU, against the same engine on
`LocalMesh` on the same mesh, f64. The `LocalMesh` engine is held against
the JAX functions and the single-device engine in
tests/test_torch_domain.py and tests/test_torch_domain_sim.py.

Systems: WATER30 replicated (3,2,2) (360 atoms, 24 x 16 x 16 A) on mesh
(3,2,1) over 6 ranks, and WATER30 x 2^3 (240 atoms, a 16 A cube) on
(2,2,2) over 8 ranks; ANI-2x, one model. Each mesh's ranks and its
`LocalMesh` reference run `_dist_workers.domain_case` at once, each in
processes of its own (one spawn a mesh for the module). Compared:

  * one evaluation from the system moved across the brick faces, on the
    xla (mirror-ext) and the pallas_asn engines (the kernels' plain
    versions): the forces in input order bit for bit, pe and the virial
    within 1e-13 relative, the slot layout after migration, and the
    potential's parameters and the sizing, equal on every rank;
  * (3,2,1): NVE over 3 steps (a rebuild every 2, migrating): positions,
    velocities and forces bit for bit; NoseHoover from a restart saved on
    `LocalMesh`, saved again on the group and loaded on `LocalMesh`
    (within 1e-12, the loads bit for bit); NoseHooverNPT within 1e-12,
    the box the same bits on every rank; halo capacities at a sixth of
    the auto spec's, regrown alike on every rank;
  * (2,2,2): Langevin by its temperature (each rank draws its own
    noise); a skin violation recovered from, bit for bit;
  * every gid once after every run that migrates; a mesh of another
    shape or device than the engine's raises.
"""

import numpy as np
import pytest
import torch

from lammps_ani_torch.md import integrate
from lammps_ani_torch.models import zoo
from lammps_ani_torch.parallel.comm import LocalMesh
from lammps_ani_torch.parallel.domain import DomainSpec
from lammps_ani_torch.parallel.sim import DomainSimulation

from . import _dist_workers as workers

A, B = (3, 2, 1), (2, 2, 2)
ENGINES = ["xla", "pallas_asn"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: (each rank's results, LocalMesh's)}, and the directory."""
    d = tmp_path_factory.mktemp("domain_dist")
    # the restart the (3,2,1) runs start NoseHoover from
    dsim, data = workers.engine(LocalMesh(A), integrator=integrate.NoseHoover(
        **workers.NH))
    dsim.save_restart(d / "local.npz", workers.start(dsim, data, temp=300.0))
    with workers.Ranks("domain", A, d / "a_pg") as a, \
            workers.Ranks("domain", B, d / "b_pg") as b, \
            workers.Ranks("domain", A, d / "a_local", local=True) as la, \
            workers.Ranks("domain", B, d / "b_local", local=True) as lb:
        out = {A: (a.join(), la.join()[0]), B: (b.join(), lb.join()[0])}
    return out, d


def same(x, y):
    return np.array_equal(np.asarray(x), np.asarray(y))


def rel(x, y):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-300))


def gids_once(layout, n):
    gid = np.asarray(layout).ravel()
    return np.array_equal(np.sort(gid[gid >= 0]), np.arange(n))


def natoms(mesh):
    return 30 * int(np.prod(workers.SYSTEM[mesh]))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mesh", [A, B])
def test_evaluation_matches_local(runs, mesh, engine):
    res, local = runs[0][mesh]
    ref = local[f"eval_{engine}"]
    assert len(res) == int(np.prod(mesh)) and ref["engine"] == engine
    for out in (o[f"eval_{engine}"] for o in res):
        assert out["engine"] == engine
        assert same(out["force"], ref["force"])
        assert same(out["pos"], ref["pos"])
        assert same(out["layout"], ref["layout"])
        assert rel(out["pe"], ref["pe"]) <= 1e-13
        assert rel(out["virial"], ref["virial"]) <= 1e-13
        # every rank gathered the same arrays and holds the same sums
        assert same(out["force"], res[0][f"eval_{engine}"]["force"])
        assert same(out["virial"], res[0][f"eval_{engine}"]["virial"])
    assert gids_once(ref["layout"], natoms(mesh))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mesh", [A, B])
def test_parameters_and_sizing_equal_on_every_rank(runs, mesh, engine):
    res, local = runs[0][mesh]
    ref = local[f"eval_{engine}"]
    assert ref["mesh"] == ("local", int(np.prod(mesh)))
    for out in (o[f"eval_{engine}"] for o in res):
        assert out["mesh"] == ("gloo", 1)
        assert out["params"] == ref["params"]
        assert out["sizing"] == ref["sizing"]


@pytest.mark.parametrize("what", ["shape", "device"])
def test_a_mesh_of_another_shape_or_device_raises(what):
    mesh = (LocalMesh((2, 1, 1)) if what == "shape"
            else LocalMesh(B, device="meta"))
    pot = zoo.ani2x(num_models=1, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match=r"mesh of shape .* on .* for an "
                       r"engine of dspec.mesh_shape \(2, 2, 2\) on cpu"):
        DomainSimulation(pot, DomainSpec(B, 64, (64, 64, 64)),
                         dtype=torch.float64, device="cpu", mesh=mesh)


def test_nve_bit_for_bit(runs):
    res, local = runs[0][A]
    ref = local["nve"]
    assert not same(ref["layout"], ref["layout_before"])  # atoms migrated
    assert gids_once(ref["layout"], natoms(A))
    for out in (o["nve"] for o in res):
        for key in ("pos", "vel", "force", "layout"):
            assert same(out[key], ref[key]), key
        assert rel(out["pe"], ref["pe"]) <= 1e-13


def test_nose_hoover_from_a_local_restart(runs):
    res, local = runs[0][A]
    ref = local["restart_nh"]
    for out in (o["restart_nh"] for o in res):
        assert same(out["loaded"]["pos"], ref["loaded"]["pos"])
        assert same(out["loaded"]["vel"], ref["loaded"]["vel"])
        assert out["step"] == ref["step"] == 2
        for key in ("pos", "vel", "eta", "eta_dot"):
            assert rel(out[key], ref[key]) <= 1e-12, key
        for got, want in zip(out["rows"], ref["rows"]):
            for key in ("pe", "ke", "temp", "press"):
                assert got[key] == pytest.approx(want[key], rel=1e-12), key


def test_restart_written_by_rank_0_loads_on_local(runs):
    """The group's restart (one file, rank 0's) on a `LocalMesh` engine:
    the state the group saved, bit for bit."""
    (res, _), d = runs[0][A], runs[1]
    assert sorted(p.name for p in (d / "a_pg").glob("*.npz")) == \
        ["restart.npz"]
    out = res[0]["restart_nh"]
    dsim, _ = workers.engine(LocalMesh(A), integrator=integrate.NoseHoover(
        **workers.NH))
    st = dsim.load_restart(d / "a_pg" / "restart.npz")
    assert isinstance(dsim, DomainSimulation) and st.step == 2
    assert same(dsim.gather(st, "vel"), out["vel"])
    assert same(st.thermostat.eta, out["eta"])
    assert same(st.thermostat.eta_dot, out["eta_dot"])
    with np.load(d / "a_pg" / "restart.npz") as z:
        assert same(z["pos"], out["pos"])


def test_npt_box_the_same_bits_on_every_rank(runs):
    res, local = runs[0][A]
    ref = local["npt"]
    assert not same(ref["h"], np.diag([24.0, 16.0, 16.0]))  # the box moved
    for out in (o["npt"] for o in res):
        assert out["h_bytes"] == res[0]["npt"]["h_bytes"]
        for key in ("h", "pos", "vel", "omega"):
            assert rel(out[key], ref[key]) <= 1e-12, key
        assert out["rows"][-1]["vol"] == pytest.approx(
            ref["rows"][-1]["vol"], rel=1e-12)


def test_undersized_halo_regrows_alike_on_every_rank(runs):
    res, local = runs[0][A]
    ref = local["regrow"]
    assert ref["kinds"]["halo"] > 0
    for out in (o["regrow"] for o in res):
        assert out["kinds"] == ref["kinds"]
        assert out["dspec"] == ref["dspec"]
        assert same(out["force"], ref["force"])
        assert rel(out["pe"], ref["pe"]) <= 1e-13


def test_langevin_by_its_temperature(runs):
    """Each rank draws its own noise: the trajectory leaves `LocalMesh`'s,
    its temperature does not (4 steps of 0.2 fs at damp 50 fs from 300
    K), and every rank reports the same rows."""
    res, local = runs[0][B]
    ref = local["langevin"]
    assert gids_once(ref["layout"], natoms(B))
    for out in (o["langevin"] for o in res):
        assert out["rows"] == res[0]["langevin"]["rows"]
        assert gids_once(out["layout"], natoms(B))
        assert not same(out["pos"], ref["pos"])
        for got, want in zip(out["rows"], ref["rows"]):
            assert np.isfinite(got["temp"])
            assert got["temp"] == pytest.approx(want["temp"], rel=0.02)


def test_recovers_from_a_skin_violation(runs):
    res, local = runs[0][B]
    ref = local["skin"]
    assert any(ref["stops"]) and ref["step"] == 4
    for out in (o["skin"] for o in res):
        assert out["stops"] == ref["stops"] and out["step"] == 4
        assert same(out["pos"], ref["pos"])
