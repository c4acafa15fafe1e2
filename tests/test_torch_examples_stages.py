"""The port's staged early-earth campaign
(lammps_ani_torch/examples/early_earth/run_stages.py) on the CPU.

The system is `generate.build(60)` (245 atoms of water, CH4, NH3, CO and
H2 in a 13.71 A cube, through a data file) on mesh (2,1,1), the config
the JAX script's with `auto_spec`, k_max 112 and two stages of 3 steps
(300 K, then 500 K), thermo every step; ANI-1xnr with one model, the
engine's CPU default (the mirror-ext engine):

  * `run_campaign` in f64 prints the JAX script's lines, and equals bit
    for bit the same calls made by hand on `DomainSimulation` (init_state
    at 300 K from seed 2026, `run`, the integrator swapped for
    NoseHoover(500 K) between the stages): every thermo row, the final
    positions, velocities and chain; the second stage's chain runs at 500
    K (the same stage with the chain at 300 K gives other rows);
  * the campaign resumed at stage 1 from stage 0's restart equals the
    continuous run bit for bit (rows, state, the stage-1 restart's
    arrays); the restart's keys hold the JAX engine's
    (examples/early_earth/early_earth_50k.stage0.npz);
  * `check_invariants` raises a RuntimeError naming the counts on a lost
    atom, on an atom held twice and on a non-finite total energy, and a
    `first_stage` outside the config's stages a ValueError;
  * the final fragments equal the JAX `analysis.fragments` on the same
    positions;
  * the pe at the first stage's start equals the JAX single-device mirror
    engine's (f64, the same weights) within 1e-10 relative;

tests/test_torch_examples_dist.py runs the same campaign over a gloo
process group.
"""

import math
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lammps_ani_tpu as jlat
from lammps_ani_tpu.analysis import fragments as jfrag
from lammps_ani_tpu.models import zoo as jzoo
from lammps_ani_torch.examples.early_earth import generate
from lammps_ani_torch.examples.early_earth import run_stages as rs
from lammps_ani_torch.io.lammps_data import read_lammps_data, write_lammps_data
from lammps_ani_torch.md import integrate
from lammps_ani_torch.models import zoo as tzoo
from lammps_ani_torch.ops.neighbors import Box
from lammps_ani_torch.parallel.domain import auto_domain_spec
from lammps_ani_torch.parallel.sim import DomainSimulation

from ._dist_workers import ROOT

F64 = torch.float64
N_WATER = 60
STAGES = [[300.0, 3], [500.0, 3]]
JAX_RESTART = ROOT / "examples" / "early_earth" / "early_earth_50k.stage0.npz"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(d, tag):
    cfg = rs.load_config(None)
    cfg.update(data=str(d / "ee.data"), mesh_shape=[2, 1, 1],
               auto_spec=True, k_max=112, stages=STAGES, thermo_every=1,
               restart_prefix=str(d / f"{tag}.stage"),
               log=str(d / f"{tag}.yaml"), device="cpu")
    return cfg


def system(d):
    """The data file of `generate.build(N_WATER)` under `d`, read back
    (the campaign's input)."""
    write_lammps_data(d / "ee.data", generate.build(N_WATER))
    return read_lammps_data(d / "ee.data")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The f64 campaign, its printed lines kept."""
    d = tmp_path_factory.mktemp("stages")
    data = system(d)
    lines = []
    c64 = rs.run_campaign(config(d, "f64"), device="cpu", log=lines.append,
                          dtype=F64)
    return {"dir": d, "data": data, "c64": c64, "lines": lines}


def final(dsim, state):
    """The final positions, velocities (input order) and chain."""
    return {k: dsim.gather(state, k) for k in ("pos", "vel")} | {
        "eta": state.thermostat.eta.numpy(),
        "eta_dot": state.thermostat.eta_dot.numpy()}


def same_state(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a)


def npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_prints_the_jax_scripts_lines(runs):
    lines = runs["lines"]
    thermo = re.compile(r"^  step +\d+ pe -?\d+\.\d T +\d+\.\d "
                        r"etot -?\d+\.\d$")
    want = []
    for i, (temp, steps) in enumerate(STAGES):
        want.append(f"# stage {i}: T={temp} K, {steps} steps")
        want += ["thermo"] * steps
        want.append(f"# wrote {runs['dir']}/f64.stage{i}.npz")
    n = runs["data"].n_atoms
    want.append(f"# invariants OK: etotal finite, {n} atoms conserved")
    got = ["thermo" if thermo.match(line) else line for line in lines[:-1]]
    assert got == want
    top = lines[-1].split(": ", 1)
    assert top[0] == "# final fragments" and 0 < len(top[1].split()) <= 10
    assert [int(t.split(":")[1]) for t in top[1].split()] == sorted(
        (int(t.split(":")[1]) for t in top[1].split()), reverse=True)


def by_hand(data):
    """The campaign's calls, made directly on `DomainSimulation`: (stage
    rows, the final state's arrays)."""
    pot = tzoo.ani1xnr(num_models=1, dtype=F64, device="cpu")
    rlist = max(5.1, pot.spec.cutoff) + 1.0
    dspec = auto_domain_spec(data.n_atoms, data.box_h, (2, 1, 1), rlist,
                             k_max=112)
    dsim = DomainSimulation(
        pot, dspec, cutoff=5.1, skin=1.0, rebuild_every=10, dt=0.25,
        integrator=integrate.NoseHoover(temp=300.0, tdamp=50.0), dtype=F64,
        device="cpu")
    box = Box(h=torch.tensor(data.box_h), origin=torch.tensor(
        data.box_origin))
    st = dsim.init_state(data.species, data.atom_masses, data.positions, box,
                         temp=300.0, seed=2026)
    st, rows0 = dsim.run(st, 3, thermo_every=1)
    dsim.integrator = integrate.NoseHoover(temp=500.0, tdamp=50.0)
    st, rows1 = dsim.run(st, 3, thermo_every=1)
    return [rows0, rows1], final(dsim, st)


def test_equals_the_calls_by_hand(runs):
    c = runs["c64"]
    rows, state = by_hand(runs["data"])
    assert c.rows == rows
    assert same_state(final(c.dsim, c.state), state)
    assert c.dsim.integrator.temp == 500.0 and c.dsim.engine == "xla"
    assert [r["step"] for r in c.rows[1]] == [1, 2, 3]


def resumed(runs, tag, stages=STAGES):
    """The campaign resumed at stage 1 from the f64 campaign's stage-0
    restart (copied under `tag`)."""
    d = runs["dir"]
    shutil.copy(d / "f64.stage0.npz", d / f"{tag}.stage0.npz")
    return rs.run_campaign(dict(config(d, tag), stages=stages),
                           device="cpu", log=lambda line: None, dtype=F64,
                           first_stage=1)


def test_second_stage_runs_at_500_kelvin(runs):
    """Stage 1 with the chain at 300 K gives other rows than the
    campaign's (the target temperature enters every chain step)."""
    cold = resumed(runs, "cold", [[300.0, 3], [300.0, 3]])
    c = runs["c64"]
    assert cold.dsim.integrator.temp == 300.0
    assert all(a["temp"] != b["temp"] and a["pe"] != b["pe"]
               for a, b in zip(cold.rows[0], c.rows[1]))


def test_resume_from_stage_0_equals_the_continuous_run(runs):
    d, c = runs["dir"], runs["c64"]
    r = resumed(runs, "resumed")
    assert r.rows == c.rows[1:]
    assert same_state(final(r.dsim, r.state), final(c.dsim, c.state))
    a, b = npz(d / "resumed.stage1.npz"), npz(d / "f64.stage1.npz")
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert r.fragments == c.fragments


def test_restart_keys_hold_the_jax_engines(runs):
    ours = npz(runs["dir"] / "f64.stage0.npz")
    assert set(npz(JAX_RESTART)) <= set(ours)
    assert ours["pos"].shape == (runs["data"].n_atoms, 3)


def test_invariants_raise_with_the_counts(runs):
    c = runs["c64"]
    rows = c.rows[-1]
    n = runs["data"].n_atoms
    assert rs.check_invariants(c.dsim, c.state, rows) == n
    gid = c.state.gid.clone()
    held = torch.nonzero(gid >= 0)[:, 0]
    lost = gid.clone()
    lost[held[5]] = -1
    with pytest.raises(RuntimeError, match=f"{n - 1} ids held for {n} "
                       "atoms, 1 missing, 0 held more than once"):
        rs.check_invariants(c.dsim, c.state.replace(gid=lost), rows)
    twice = gid.clone()
    twice[held[5]] = gid[held[6]]
    with pytest.raises(RuntimeError, match=f"{n} ids held for {n} atoms, "
                       "1 missing, 1 held more than once"):
        rs.check_invariants(c.dsim, c.state.replace(gid=twice), rows)
    bad = rows[:-1] + [{**rows[-1], "etotal": math.nan}]
    with pytest.raises(RuntimeError, match="not finite"):
        rs.check_invariants(c.dsim, c.state, bad)


@pytest.mark.parametrize("first_stage", [-1, 2])
def test_first_stage_out_of_range_raises(runs, first_stage):
    with pytest.raises(ValueError, match=f"first_stage {first_stage}: the "
                       "config has 2 stages"):
        rs.run_campaign(config(runs["dir"], "none"), device="cpu",
                        first_stage=first_stage)


def test_fragments_match_jax(runs):
    c = runs["c64"]
    pos = c.dsim.gather(c.state, "pos")
    _, ref = jfrag.fragments(runs["data"].species, pos,
                             c.state.box.h.numpy())
    assert c.fragments == ref.most_common(10)


def test_pe_at_the_start_matches_the_jax_mirror_engine(runs):
    data = runs["data"]
    cfg = config(runs["dir"], "pe")
    dsim = rs.make_engine(cfg, data.n_atoms, data.box_h, "cpu", dtype=F64)
    box = Box(h=torch.tensor(data.box_h), origin=torch.tensor(
        data.box_origin))
    st = dsim.evaluate(dsim.init_state(data.species, data.atom_masses,
                                       data.positions, box, temp=300.0,
                                       seed=rs.VELOCITY_SEED))
    params = [[{k: jnp.asarray(v.numpy()) for k, v in layer.items()}
               for layer in layers] for layers in dsim.potential.params]
    jpot = jzoo.ani1xnr(num_models=1, dtype=jnp.float64, params=params)
    jsim = jlat.Simulation(
        potential=jpot, species=data.species, masses=data.atom_masses,
        nbr=jlat.NeighborConfig(cutoff=5.1, skin=2.0, ghost_capacity=4096,
                                rebuild_every=10),
        dt=0.25, dtype=jnp.float64)
    jst = jsim.init_state(data.positions, jlat.Box(
        h=jnp.asarray(data.box_h), origin=jnp.asarray(data.box_origin)))
    ref = float(jst.pe)
    assert abs(float(st.pe) - ref) <= 1e-10 * abs(ref)
