"""The port's `energy_forces_virial_roll` vs the JAX package's, f64.

The whole potential on the slice's path: both AEV channels over one fine
roll grid (the JAX side through its Pallas kernels in interpret mode),
the species-sorted MLP ensemble, forces and the strain virial. Same
system, weights, grid, bins and caps on both sides; WATER30 replicated
2x2x2, atoms sorted by species. The JAX result is computed once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ani_tpu.models import potential as jpotmod
from lammps_ani_tpu.models import zoo as jzoo
from lammps_ani_tpu.ops import cell_roll as jcr
from lammps_ani_tpu.ops import neighbors as jnb
from lammps_ani_torch.models import networks as tnet
from lammps_ani_torch.models import potential as tpotmod
from lammps_ani_torch.models import zoo as tzoo
from lammps_ani_torch.ops import aev_roll as taev_roll
from lammps_ani_torch.ops import cell_roll as tcr
from lammps_ani_torch.ops import neighbors as tnb

from .test_torch_neighbors import boxes, water_system

CAPS = (20, 0, 0, 12, 0, 0, 0)

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
def efv():
    species, pos, h, origin, _ = water_system(2, jitter=0.05, seed=4)
    order = np.argsort(species, kind="stable")
    species, pos = species[order], pos[order]
    counts = tuple(int((species == s).sum()) for s in range(7))
    jbox, tbox = boxes(h, origin)
    jpos = jnb.wrap_positions(jnp.asarray(pos), jbox)
    tpos = tnb.wrap_positions(torch.tensor(pos), tbox)
    jgrid = jcr.RollGrid.for_box(h, 4.5, 16)
    tgrid = tcr.RollGrid.for_box(h, 4.5, 16)
    jbins = jcr.build_bins(jgrid, jpos, jnp.asarray(species), jbox)
    tbins = tcr.build_bins(tgrid, tpos, torch.tensor(species), tbox)
    assert int(tbins.count_max) <= tgrid.cap
    import dataclasses
    jpot = jzoo.ani2x(num_models=2, dtype=jnp.float64)
    jpot = jpotmod.ANIPotential(
        spec=dataclasses.replace(jpot.spec, angular_caps=CAPS),
        params=jpot.params)
    tpot = tzoo.ani2x(num_models=2, dtype=torch.float64, device="cpu",
                      params=tzoo.params_from_numpy(
                          jax.tree.map(np.asarray, jpot.params)))
    tpot = tpot.with_spec(dataclasses.replace(tpot.spec, angular_caps=CAPS))
    ref = jpotmod.energy_forces_virial_roll(
        jpot, jnp.asarray(species), jpos, jbox, jgrid, jbins,
        radial_shell=2, species_counts=counts)
    got = tpotmod.energy_forces_virial_roll(
        tpot, torch.tensor(species), tpos, tbox, tgrid, tbins,
        radial_shell=2, species_counts=counts)
    return ([np.asarray(x) for x in ref], [x.detach().numpy() for x in got],
            dict(pot=tpot, species=species, pos=tpos, box=tbox, grid=tgrid,
                 bins=tbins, counts=counts))


def test_energy_matches_jax(efv):
    ref, got, _ = efv
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-11)


def test_forces_match_jax(efv):
    ref, got, _ = efv
    assert np.abs(ref[1]).max() > 1e-3
    np.testing.assert_allclose(got[1], ref[1], atol=1e-9)


def test_virial_matches_jax(efv):
    ref, got, _ = efv
    np.testing.assert_allclose(got[2], ref[2], atol=1e-8)
    np.testing.assert_allclose(got[2], got[2].T, atol=1e-12)


def test_deficit_matches_jax(efv):
    ref, got, _ = efv
    assert float(got[3]) == float(ref[3]) <= 0


def test_masked_networks_give_the_same_energy(efv):
    """The roll path's species-sorted MLP gives, atom by atom, what the
    masked MLP gives on the same AEV, and its energies sum to E."""
    _, got, p = efv
    pot, counts = p["pot"], p["counts"]
    spec = pot.spec
    species = torch.tensor(p["species"])
    e_atoms, _ = tpotmod.atomic_energies_roll(
        pot, species, p["pos"], p["box"], p["grid"], p["bins"], counts)
    radial = taev_roll.radial_aev_roll(spec.aev, p["grid"], p["bins"],
                                       p["pos"], p["box"],
                                       species_counts=counts, shell=2)
    angular, _ = taev_roll.angular_aev_roll(spec.aev, p["grid"], p["bins"],
                                            p["pos"], p["box"],
                                            spec.angular_caps,
                                            species_counts=counts)
    masked = (tnet.ensemble_energies(tnet.atomic_energies_masked(
        spec.net, pot.params, species, torch.cat([radial, angular], 1)))
        + spec.shifter(species, dtype=torch.float64))
    np.testing.assert_allclose(e_atoms.detach().numpy(),
                               masked.detach().numpy(), rtol=1e-13)
    np.testing.assert_allclose(float(e_atoms.sum()), got[0], rtol=1e-13)


def test_energy_is_translation_invariant(efv):
    _, got, p = efv
    shifted = tnb.wrap_positions(p["pos"] + torch.tensor([0.3, -0.2, 0.1],
                                                         dtype=torch.float64),
                                 p["box"])
    bins = tcr.build_bins(p["grid"], shifted, torch.tensor(p["species"]),
                          p["box"])
    e, f, _, _ = tpotmod.energy_forces_virial_roll(
        p["pot"], torch.tensor(p["species"]), shifted, p["box"], p["grid"],
        bins, radial_shell=2, species_counts=p["counts"])
    np.testing.assert_allclose(float(e), got[0], rtol=1e-12)
    np.testing.assert_allclose(f.numpy().sum(0), 0.0, atol=1e-9)
