"""The npt ensemble on the port's roll engine (pallas_full: the four roll
kernels, here their plain versions) against the JAX package's mirror
engine, f64, and the roll grid re-derived under the barostat.

System: WATER30 x 3^3 (810 atoms) in a box scaled by 0.976 (23.4 A), so
that its fine grid (4^3 bins, side >= 1.06 max(Rca + skin, (Rcr + skin) /
2) under a barostat) sits 6.5% above the engine's side;
NoseHooverNPT(300 K, tdamp 20, 1 atm, pdamp 100), dt 0.2 fs, a rebuild
every 2 steps, explicit velocities, one step (the roll engine's plain
kernels are the slowest of the CPU paths). Bounds as
tests/test_torch_npt_asn.py's: forces within 1e-12 of the largest, the
virial within 5.8e-11 of its largest entry, pe rtol 1e-11, positions
1e-10 A, box.h, the chain and the piston rtol 1e-10.

Re-derive: the end state's box and positions scaled by 0.93 take the fine
grid past its slack (in both packages' `_grids_valid`); the grid the port
re-derives (`_rederive_grids`, what `run` calls at the top of a chunk:
3^3 bins, and the radial window back to shell 1, since a bin now reaches
Rcr + skin) equals the JAX roll engine's `_setup_grids`, shell included,
and the angular kernels' cap check passes at its cap. A chunk through
`run` after a re-derive is tests/test_torch_npt_asn.py's and
chip_smoke.py's `nvt_npt` phase on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lammps_ani_tpu as jlat
import lammps_ani_torch as tlat
from lammps_ani_tpu.md import integrate as jint

from .test_torch_mirror import _pots
from .test_torch_npt import ENSEMBLES, run_pair, states_close
from .test_torch_npt_asn import NBR, forces_close, shrink, tile

SIDE = 5.5  # max(Rca + skin, (Rcr + skin) / 2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def npt_full():
    s = tile(scale=4 * 1.065 * SIDE / 24.0)
    return s, run_pair(s, "npt", 1, 0.2, NBR, engine="pallas_full")


def test_npt_roll_matches_jax(npt_full):
    _, (jsim, jst, tsim, tst, rows) = npt_full
    assert tsim.engine == "pallas_full" and tsim._roll_shell == 2
    assert tuple(tsim._roll_grid.ncells) == (4, 4, 4)
    assert tsim.regrow_events == 0
    states_close(jsim, jst, tsim, tst, 1e-10, 1e-10)
    assert float(tst.pe) == pytest.approx(float(jst.pe), rel=1e-11)
    forces_close(jsim, jst, tsim, tst)
    assert rows[-1]["vol"] == pytest.approx(float(tst.box.volume), rel=1e-14)


def test_rederived_grid_matches_jax(npt_full, monkeypatch):
    s, (_, _, tsim, tst, _) = npt_full
    monkeypatch.setenv("LAT_ROLL_IMPL", "pallas_full")
    jpot, _ = _pots(False, caps=None)
    jg = jlat.Simulation(potential=jpot, species=s["species"],
                         masses=s["masses"], nbr=jlat.NeighborConfig(**NBR),
                         dt=0.2, dtype=jnp.float64, cellroll=True,
                         **ENSEMBLES["npt"](jint))

    def jax_grid(pos, h):
        box = jlat.Box(h=jnp.asarray(h), origin=jnp.asarray(s["origin"]))
        jg._spatial_sort(np.asarray(pos), box)
        jg._setup_grids(jnp.asarray(np.asarray(pos)[jg.order]), box)
        return (tuple(jg._roll_grid.ncells), jg._roll_grid.cap,
                jg._roll_shell)

    def grid():
        return (tuple(tsim._roll_grid.ncells), tsim._roll_grid.cap,
                tsim._roll_shell)

    assert grid() == jax_grid(s["pos"], s["h"])
    st = shrink(tlat.Box, tst)
    h_now = st.box.h.numpy()
    assert not tsim._grids_valid(h_now) and not jg._grids_valid(h_now)
    tsim._rederive_grids(st)
    assert grid()[0] == (3, 3, 3) and grid()[2] == 1
    assert grid() == jax_grid(tsim.positions_input_order(st), h_now)
    assert tsim._grids_valid(h_now) and tsim.engine == "pallas_full"
