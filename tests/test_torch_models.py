"""Port models vs the JAX package: AEV oracle, networks, weights, .npz.

f64 throughout; tolerance 1e-12 relative (the two frameworks sum in
different orders, nothing else differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ani_tpu.models import aev as jaev
from lammps_ani_tpu.models import networks as jnet
from lammps_ani_tpu.models import zoo as jzoo
from lammps_ani_tpu.ops import neighbors as jnb
from lammps_ani_torch.models import aev as taev
from lammps_ani_torch.models import networks as tnet
from lammps_ani_torch.models import zoo as tzoo

from .test_torch_neighbors import water_system

RTOL = 1e-12

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: with several test processes on one machine, each
    with a thread per core, the threads wait on one another at every
    operation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL,
                               atol=RTOL * max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def jax_pot():
    return jzoo.ani2x(num_models=2, dtype=jnp.float64)


def test_specs_match():
    for jf, tf in ((jaev.ani2x_aev_spec, taev.ani2x_aev_spec),
                   (jaev.ani1x_aev_spec, taev.ani1x_aev_spec)):
        j, t = jf(), tf()
        assert vars(j) == vars(t)
        assert j.aev_length == t.aev_length
        np.testing.assert_array_equal(j.triu_index(), t.triu_index())
    assert taev.ani2x_aev_spec().aev_length == 1008
    assert tnet.ANI2X_HIDDEN == jnet.ANI2X_HIDDEN
    assert tnet.ANI2X_SELF_ENERGIES == jnet.ANI2X_SELF_ENERGIES


@pytest.mark.parametrize("rep,capacity", [(1, 32), (2, 32), (2, 8)])
def test_compute_aev_matches_jax(rep, capacity):
    """The generic oracle on the same padded neighbor matrix (capacity 8
    truncates the angular compaction: both must drop the same slots)."""
    species, pos, h, origin, _ = water_system(rep)
    box = jnb.Box(h=jnp.asarray(h), origin=jnp.asarray(origin))
    p = jnb.wrap_positions(jnp.asarray(pos), box)
    ghosts = jnb.build_ghosts(p, box, 5.1, 8192, jnb.image_shifts(1))
    nl = jnb.build_neighbor_matrix_brute(p, box, 5.1, 96, ghosts)
    diff, dist = jnb.neighbor_displacements(p, box, nl)
    sj = jnb.extended_species(jnp.asarray(species), nl.ghosts)[nl.idx]
    mask = nl.mask & (sj >= 0)
    spec = jaev.ani2x_aev_spec()
    ref = jaev.compute_aev(spec, jnp.asarray(species), diff, dist, sj, mask,
                           angular_capacity=capacity)
    got = taev.compute_aev(
        taev.ani2x_aev_spec(), torch.tensor(species),
        torch.tensor(np.asarray(diff)), torch.tensor(np.asarray(dist)),
        torch.tensor(np.asarray(sj)), torch.tensor(np.asarray(mask)),
        angular_capacity=capacity)
    close(got.numpy(), ref)


def test_terms_match_jax():
    rng = np.random.default_rng(1)
    r1, r2 = rng.uniform(0.7, 4.0, (2, 64))
    cos = rng.uniform(-1.0, 1.0, 64)
    js, ts = jaev.ani2x_aev_spec(), taev.ani2x_aev_spec()
    close(taev.radial_terms(ts, torch.tensor(r1)).numpy(),
          jaev.radial_terms(js, jnp.asarray(r1)))
    close(taev.angular_terms(ts, torch.tensor(r1), torch.tensor(r2),
                             torch.tensor(cos)).numpy(),
          jaev.angular_terms(js, jnp.asarray(r1), jnp.asarray(r2),
                             jnp.asarray(cos)))
    close(taev.cutoff_cosine(torch.tensor(r1), 3.5).numpy(),
          jaev.cutoff_cosine(jnp.asarray(r1), 3.5))


def test_params_from_numpy_matches_pytree(jax_pot):
    params = tzoo.params_from_numpy(jax.tree.map(np.asarray, jax_pot.params))
    assert len(params) == len(jax_pot.params) == 7
    for tl, jl in zip(params, jax_pot.params):
        assert len(tl) == len(jl) == 4
        for t, j in zip(tl, jl):
            for k in ("w", "b"):
                assert t[k].dtype == torch.float64
                np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


@pytest.mark.parametrize("counts", [(160, 0, 0, 80, 0, 0, 0),
                                    (5, 3, 2, 4, 1, 1, 1)])
def test_atomic_energies_sorted_matches_jax(jax_pot, counts):
    n = sum(counts) + 3  # + padding tail
    aev = np.random.default_rng(2).standard_normal((n, 1008)) * 0.1
    params = tzoo.params_from_numpy(jax.tree.map(np.asarray, jax_pot.params))
    spec = jax_pot.spec.net
    ref = jnet.atomic_energies_sorted(spec, jax_pot.params, counts,
                                      jnp.asarray(aev))
    got = tnet.atomic_energies_sorted(
        tnet.NetworkSpec(spec.aev_length, spec.hidden, spec.celu_alpha),
        params, counts, torch.tensor(aev))
    close(got.numpy(), ref)


def test_atomic_energies_gradient_matches_jax(jax_pot):
    """d(sum E)/d(aev), the chain the forces go through. PyTorch's own
    celu backward loses digits for negative inputs, even in f64 (with it
    this check fails by 1.5e-11); the port's CELU keeps JAX's."""
    counts = (160, 0, 0, 80, 0, 0, 0)
    aev = np.random.default_rng(0).uniform(0.0, 2.0, (240, 1008))
    params = tzoo.params_from_numpy(jax.tree.map(np.asarray, jax_pot.params))
    spec = jax_pot.spec.net
    ref = jax.grad(lambda a: jnp.sum(jnet.atomic_energies_sorted(
        spec, jax_pot.params, counts, a)))(jnp.asarray(aev))
    x = torch.tensor(aev, requires_grad=True)
    e = tnet.atomic_energies_sorted(
        tnet.NetworkSpec(spec.aev_length, spec.hidden, spec.celu_alpha),
        params, counts, x).sum()
    (got,) = torch.autograd.grad(e, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=RTOL * np.abs(np.asarray(ref)).max())


def test_atomic_energies_masked_and_shifter_match_jax(jax_pot):
    rng = np.random.default_rng(3)
    species = rng.integers(-1, 7, 40).astype(np.int32)
    aev = rng.standard_normal((40, 1008)) * 0.1
    params = tzoo.params_from_numpy(jax.tree.map(np.asarray, jax_pot.params))
    spec = jax_pot.spec.net
    tspec = tnet.NetworkSpec(spec.aev_length, spec.hidden, spec.celu_alpha)
    ref = jnet.atomic_energies_masked(spec, jax_pot.params,
                                      jnp.asarray(species), jnp.asarray(aev))
    got = tnet.atomic_energies_masked(tspec, params, torch.tensor(species),
                                      torch.tensor(aev))
    close(got.numpy(), ref)
    close(tnet.ensemble_energies(got).numpy(), jnet.ensemble_energies(ref))
    shift = tnet.EnergyShifter(tnet.ANI2X_SELF_ENERGIES)
    close(shift(torch.tensor(species), dtype=torch.float64).numpy(),
          jax_pot.spec.shifter(jnp.asarray(species), dtype=jnp.float64))


def test_npz_jax_to_port(jax_pot, tmp_path):
    path = tmp_path / "jax.npz"
    jzoo.save_potential(path, jax_pot)
    pot = tzoo.load_potential(path, dtype=torch.float64, device="cpu")
    assert pot.spec.aev == taev.ani2x_aev_spec()
    assert pot.spec.net.hidden == jax_pot.spec.net.hidden
    assert pot.spec.shifter.self_energies == jax_pot.spec.shifter.self_energies
    assert pot.num_models == 2
    for tl, jl in zip(pot.params, jax_pot.params):
        for t, j in zip(tl, jl):
            for k in ("w", "b"):
                np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


def test_npz_port_to_jax(tmp_path):
    pot = tzoo.ani2x(num_models=3, seed=5, dtype=torch.float64, device="cpu")
    path = tmp_path / "port.npz"
    tzoo.save_potential(path, pot)
    jpot = jzoo.load_potential(path, dtype=jnp.float64)
    assert jpot.spec.repulsion is None
    assert jpot.spec.aev == jaev.ani2x_aev_spec()
    assert jpot.num_models == 3
    for tl, jl in zip(pot.params, jpot.params):
        for t, j in zip(tl, jl):
            for k in ("w", "b"):
                np.testing.assert_array_equal(np.asarray(j[k]), t[k].numpy())


def test_synthetic_weights_scale_and_seed():
    """Damped-Kaiming scale of the JAX factory; same seed, same weights;
    f32 and f64 potentials hold the same (f32-drawn) weights."""
    a = tzoo.ani2x(num_models=1, seed=7, dtype=torch.float64, device="cpu")
    b = tzoo.ani2x(num_models=1, seed=7, dtype=torch.float32, device="cpu")
    w0 = a.params[0][0]["w"]
    assert abs(float(w0.std()) - np.sqrt(2.0 / 1008) * 0.5) < 2e-3
    np.testing.assert_array_equal(w0.numpy(),
                                  b.params[0][0]["w"].double().numpy())
    wl = a.params[0][3]["w"]
    assert float(wl.std()) < 0.05 * np.sqrt(2.0 / 160) * 1.5
