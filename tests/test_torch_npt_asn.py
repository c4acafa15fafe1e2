"""The npt ensemble on the port's asn engine (pallas_asn: the main path's
eight kernels, here their plain versions) against the JAX package's mirror
engine, f64, and a forced re-derive of the grid under the barostat.

NPT: WATER30 x 3^3 (810 atoms, 24 A box), NoseHooverNPT(300 K, tdamp 20,
1 atm, pdamp 100), dt 0.2 fs, a rebuild every 2 steps, explicit
velocities, 4 steps; the asn engine with both pair stages ("packed" and
"blocks") against the JAX `Simulation`'s default engine. The box changes
every step, and the box cotangent of the asn backward is the virial that
drives the piston. Bounds: forces within 1e-12 of the largest (the f64
baseline of the asn engine against the mirror, 3.3e-13, widened 3x for
four steps; measured 2.9e-14), the virial within 5.8e-11 of its largest
entry (the baseline; measured 5.8e-15), pe rtol 1e-11, positions 1e-10 A,
box.h, the chain and the piston rtol 1e-10 (measured: pe and box.h equal,
positions 1.2e-14 A).

Re-derive: the same tile spread to a box whose 4^3 grid (side >= 1.06
(Rcr + skin)) sits 6.5% above the engine's side, 2 steps; then the
state's box and positions are scaled by 0.93 about the origin in both
packages, which takes the grid past its 6% slack (the JAX engine's
`_grids_valid` says so too). One more chunk: `run` re-derives the grid at
its top (`regrow_events` rises by exactly one, so the capacities are sized
with margins 1.5 that hold the 24% denser box), the new grid equals the
one the JAX asn engine's `_setup_grids` derives from the same state, and
the chunk's end state matches the JAX run's as above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lammps_ani_tpu as jlat
import lammps_ani_torch as tlat
from lammps_ani_tpu.md import integrate as jint
from lammps_ani_torch.md import simulation as tsm

from .test_torch_mirror import _pots
from .test_torch_neighbors import water_system
from .test_torch_npt import ENSEMBLES, run_pair, states_close

NBR = dict(cutoff=5.1, skin=2.0, ghost_capacity=8192, rebuild_every=2)
SHRINK = 0.93


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tile(rep=3, scale=1.0):
    species, pos, h, origin, masses = water_system(rep)
    pos = origin + (pos - origin) * scale
    return dict(species=species, pos=pos, h=h * scale, origin=origin,
                masses=masses,
                vel0=0.002 * np.random.default_rng(3).standard_normal(
                    pos.shape))


@pytest.fixture(scope="module")
def npt810():
    s = tile()
    out = run_pair(s, "npt", 4, 0.2, NBR, engine="pallas_asn")
    return s, out[:2]


def forces_close(jsim, jst, tsim, tst):
    fj = np.asarray(jst.force)[jsim.inv_order]
    ft = tsim.forces_input_order(tst)
    assert np.abs(ft - fj).max() <= 1e-12 * np.abs(fj).max()
    wj = np.asarray(jst.virial)
    assert np.abs(tst.virial.numpy() - wj).max() <= 5.8e-11 * np.abs(
        wj).max()


@pytest.mark.parametrize("stage", ["packed", "blocks"])
def test_npt_asn_matches_jax(npt810, stage):
    s, jref = npt810
    jsim, jst, tsim, tst, rows = run_pair(s, "npt", 4, 0.2, NBR,
                                          engine="pallas_asn", stage=stage,
                                          jsteps=jref)
    assert tsim.engine == "pallas_asn" and tsim.pair_stage == stage
    assert tsim.regrow_events == 0
    states_close(jsim, jst, tsim, tst, 1e-10, 1e-10)
    assert float(tst.pe) == pytest.approx(float(jst.pe), rel=1e-11)
    forces_close(jsim, jst, tsim, tst)
    assert rows[-1]["vol"] == pytest.approx(float(tst.box.volume), rel=1e-14)


def shrink(box_cls, st):
    """The state with its box and positions scaled by SHRINK about the
    box origin."""
    box = box_cls(h=st.box.h * SHRINK, origin=st.box.origin)
    return st.replace(box=box, pos=box.origin + (st.pos - box.origin)
                      * SHRINK)


def jax_asn_grid(monkeypatch, s, pos, h):
    """The roll grid the JAX asn engine's `_setup_grids` derives for
    positions `pos` (caller order) in box `h` under NoseHooverNPT, as
    ((ncells), cap), and that engine."""
    monkeypatch.setenv("LAT_ROLL_IMPL", "pallas_asn")
    jpot, _ = _pots(False, caps=None)
    jg = jlat.Simulation(potential=jpot, species=s["species"],
                         masses=s["masses"], nbr=jlat.NeighborConfig(**NBR),
                         dt=0.2, dtype=jnp.float64, cellroll=True,
                         **ENSEMBLES["npt"](jint))
    box = jlat.Box(h=jnp.asarray(h), origin=jnp.asarray(s["origin"]))
    jg._spatial_sort(np.asarray(pos), box)
    jg._setup_grids(jnp.asarray(np.asarray(pos)[jg.order]), box)
    return (tuple(jg._roll_grid.ncells), jg._roll_grid.cap), jg


def grid_of(sim):
    return tuple(sim._roll_grid.ncells), sim._roll_grid.cap


def test_forced_rederive_matches_jax(monkeypatch):
    side = 1.06 * (5.1 + 2.0)
    s = tile(scale=4 * 1.065 * 7.1 / 24.0)  # 4 bins of 1.065 (Rcr + skin)
    monkeypatch.setattr(tsm, "SEC_MARGIN", 1.5)
    monkeypatch.setattr(tsm, "ANG_CAP_MARGIN", 1.5)
    jsim, jst, tsim, tst, _ = run_pair(s, "npt", 2, 0.2, NBR,
                                       engine="pallas_asn")
    assert grid_of(tsim)[0] == (4, 4, 4)
    jgrid0, jg0 = jax_asn_grid(monkeypatch, s, s["pos"], s["h"])
    assert grid_of(tsim) == jgrid0
    jst, _ = jsim.run(shrink(jlat.Box, jst), 2)
    tst = shrink(tlat.Box, tst)
    h_now = tst.box.h.numpy()
    assert not tsim._grids_valid(h_now) and not jg0._grids_valid(h_now)
    jgrid = jax_asn_grid(monkeypatch, s, tsim.positions_input_order(tst),
                         h_now)[0]
    assert min(np.diag(h_now)) / 3 >= side  # 3 bins still fit
    events = tsim.regrow_events
    tst, _ = tsim.run(tst, 2)
    assert tsim.regrow_events == events + 1
    assert tsim.engine == "pallas_asn" and tsim._roll_grid.ncells == (3, 3, 3)
    assert grid_of(tsim) == jgrid
    states_close(jsim, jst, tsim, tst, 1e-10, 1e-10)
    forces_close(jsim, jst, tsim, tst)
