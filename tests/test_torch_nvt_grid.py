"""The nvt ensemble (NoseHoover) and the Berendsen barostat (NVE +
BerendsenBarostat) on the port's grid engines against the JAX package's
mirror engine, f64: pallas_asn (plain versions of the main path's
kernels) and pallas_full (plain versions of the roll kernels) on WATER30 x
2^3 (240 atoms) spread to a 22.8 A box, where a 3^3 coarse grid fits even
with the barostat's 6% slack, so one JAX run of each ensemble serves both
engines. dt 0.2 fs, a rebuild every 2 steps, explicit velocities, 2 steps.
Bounds as tests/test_torch_npt_asn.py's: forces within 1e-12 of the
largest, the virial within 5.8e-11 of its largest entry, pe rtol 1e-11,
positions 1e-10 A, box.h and the chain rtol 1e-10.
"""

import numpy as np
import pytest
import torch

from .test_torch_npt import run_pair, states_close
from .test_torch_npt_asn import NBR, forces_close, tile


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs():
    """The system and each ensemble's JAX run, made on first use."""
    s = tile(rep=2, scale=22.8 / 16.0)
    runs = {}

    def get(ensemble, engine):
        out = run_pair(s, ensemble, 2, 0.2, NBR, engine=engine,
                       jsteps=runs.get(ensemble))
        runs[ensemble] = out[:2]
        return out

    return s, get


@pytest.mark.parametrize("engine", ["pallas_asn", "pallas_full"])
@pytest.mark.parametrize("ensemble", ["nvt", "berendsen"])
def test_grid_engine_matches_jax(jax_runs, engine, ensemble):
    s, get = jax_runs
    jsim, jst, tsim, tst, _ = get(ensemble, engine)
    assert tsim.engine == engine and tsim.regrow_events == 0
    states_close(jsim, jst, tsim, tst, 1e-10, 1e-10)
    assert float(tst.pe) == pytest.approx(float(jst.pe), rel=1e-11)
    forces_close(jsim, jst, tsim, tst)
    if ensemble == "berendsen":
        assert not np.allclose(tst.box.h.numpy(), s["h"])
