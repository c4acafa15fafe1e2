"""The plain versions of the four roll-grid AEV kernels vs the JAX
functions that reach the Pallas kernels (interpret mode), f32 — the
production dtype, guarding f32-only failure modes (exp underflow of the
outer shells, the e_j flush). Same system as test_torch_aev_roll.py.

Tolerances (as tests/test_aev_pallas.py): AEV atol 5e-6 rtol 1e-5;
dpos atol 2e-4.
"""

import numpy as np
import pytest
import torch

from .test_torch_aev_roll import port_outputs, roll_case

TOL32 = {"radial": dict(atol=5e-6, rtol=1e-5),
         "angular": dict(atol=5e-6, rtol=1e-5),
         "radial_dpos": dict(atol=2e-4, rtol=0),
         "angular_dpos": dict(atol=2e-4, rtol=0)}

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: with several test processes on one machine, each
    with a thread per core, the threads wait on one another at every
    operation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def case32():
    port, ref = roll_case(torch.float32)
    return port, ref, port_outputs(port)


@pytest.mark.parametrize("quantity", sorted(TOL32))
def test_plain_matches_jax_f32(case32, quantity):
    _, ref, got = case32
    assert got[quantity].dtype == np.float32
    assert np.abs(ref[quantity]).max() > 0
    np.testing.assert_allclose(got[quantity], ref[quantity],
                               **TOL32[quantity])


def test_outer_radial_shells_survive_f32(case32):
    """Every radial shift column of a present species is nonzero
    somewhere: no f32 underflow zeroes the outer shells."""
    got = case32[2]["radial"]
    for s in (0, 3):
        assert (np.abs(got[:, s * 16:(s + 1) * 16]).max(axis=0) > 0).all()
