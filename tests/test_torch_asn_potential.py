"""The port's asn potential (`energy_forces_virial_asn`: the fused asn
forward, the compact-AEV MLP and the XTB repulsion term, differentiated by
autograd through the kernels' plain versions) vs the JAX package's, f64.

System and sizing as test_torch_asn_build.py (WATER30 x 3^3, 810 atoms,
sorted by species, 3x3x3 coarse bins at cap 40); two occupancy tiers
(tier 0 at caps - 4); ANI-2x with repulsion, two models, the JAX
package's synthetic weights carried over by `params_from_numpy`. Each
side builds its own assignment. The JAX result is computed once.

Tolerances (as test_torch_potential.py): pe rtol 1e-11, F atol 1e-9,
W atol 1e-8; with repulsion off, per-atom energies against the port's roll
engine at 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ani_tpu.models import networks as jnet
from lammps_ani_tpu.models import potential as jpotmod
from lammps_ani_tpu.models import repulsion as jrep
from lammps_ani_tpu.models import zoo as jzoo
from lammps_ani_tpu.ops import aev_asn as jasn
import lammps_ani_torch as tlat
from lammps_ani_torch.models import networks as tnet
from lammps_ani_torch.models import potential as tpotmod
from lammps_ani_torch.models import repulsion as trep
from lammps_ani_torch.models import zoo as tzoo
from lammps_ani_torch.ops import aev_asn as tasn
from lammps_ani_torch.ops import cell_roll as tcr
from lammps_ani_torch.ops import neighbors as tnb

from .test_torch_asn_build import KEEP_R, asn_system, grids, sizing

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
    species, pos, h, origin = asn_system()
    sections, kpad, caps, _ = sizing(species, pos, h)
    counts = tuple(int((species == s).sum()) for s in range(7))
    n = len(species)
    tiers = ((tuple(max(4, c - 4) if c else 0 for c in caps), n // 2),
             (caps, n))
    j, t = grids(species, pos, h, origin)
    ja = jasn.build_assignment(j["grid"], j["bins"], j["pos"], j["box"],
                               sections, kpad, KEEP_R, interpret=True)
    ta = tasn.build_assignment(t["grid"], t["bins"], t["pos"], t["box"],
                               sections, kpad, KEEP_R)
    jpot = jzoo.ani2x(num_models=2, dtype=jnp.float64, repulsion=True)
    jpot = jpotmod.ANIPotential(
        spec=dataclasses.replace(jpot.spec, angular_caps=caps),
        params=jpot.params)
    tpot = tzoo.ani2x(num_models=2, dtype=torch.float64, device="cpu",
                      repulsion=True, params=tzoo.params_from_numpy(
                          jax.tree.map(np.asarray, jpot.params)))
    tpot = tpot.with_spec(dataclasses.replace(tpot.spec, angular_caps=caps))
    ref = jpotmod.energy_forces_virial_asn(
        jpot, jnp.asarray(species), j["pos"], j["box"],
        (j["grid"], j["bins"], ja, sections, tiers), species_counts=counts)
    t_state = (t["grid"], t["bins"], ta, sections, tiers)
    got = tpotmod.energy_forces_virial_asn(
        tpot, torch.tensor(species), t["pos"], t["box"], t_state,
        species_counts=counts)
    return ([np.asarray(x) for x in ref], [x.detach().numpy() for x in got],
            dict(pot=tpot, species=species, pos=t["pos"], box=t["box"],
                 h=h, state=t_state, counts=counts, caps=caps))


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
    """Per-species deficits and the tiers' trailing spill entry."""
    ref, got, _ = efv
    assert got[3].shape == ref[3].shape == (8,)
    np.testing.assert_array_equal(got[3], ref[3])
    assert got[3].max() <= 0


def test_energy_is_translation_invariant(efv):
    """Shifted and wrapped positions, with bins and assignment built
    anew, give the same energy; the forces sum to zero."""
    _, got, p = efv
    species = torch.tensor(p["species"])
    shifted = tnb.wrap_positions(
        p["pos"] + torch.tensor([0.3, -0.2, 0.1], dtype=torch.float64),
        p["box"])
    grid, _, _, sections, tiers = p["state"]
    bins = tcr.build_bins(grid, shifted, species, p["box"])
    asn = tasn.build_assignment(grid, bins, shifted, p["box"], sections,
                                p["state"][2].idx.shape[-1], KEEP_R)
    e, _ = tpotmod.atomic_energies_asn(
        p["pot"], species, shifted, p["box"],
        (grid, bins, asn, sections, tiers), p["counts"])
    np.testing.assert_allclose(float(e.sum()), got[0], rtol=1e-12)
    np.testing.assert_allclose(got[1].sum(0), 0.0, atol=1e-9)


def test_without_repulsion_matches_the_roll_engine(efv):
    """Cross-engine: with the repulsion term off, the asn path's per-atom
    energies equal the roll engine's (a fine 5x5x5 grid, radial shell 2)
    on the same weights and positions (f64 sums in another order)."""
    _, _, p = efv
    pot = p["pot"].with_spec(dataclasses.replace(p["pot"].spec,
                                                 repulsion=None))
    species = torch.tensor(p["species"])
    e_asn, d_asn = tpotmod.atomic_energies_asn(
        pot, species, p["pos"], p["box"], p["state"][:4], p["counts"])
    grid = tcr.RollGrid.for_box(p["h"], 4.5, 24)
    bins = tcr.build_bins(grid, p["pos"], species, p["box"])
    assert int(bins.count_max) <= grid.cap
    e_roll, d_roll = tpotmod.atomic_energies_roll(
        pot, species, p["pos"], p["box"], grid, bins, p["counts"],
        radial_shell=2)
    np.testing.assert_allclose(e_asn.numpy(), e_roll.numpy(), rtol=0,
                               atol=1e-10)
    assert d_asn.max() <= 0 and float(d_roll) <= 0


def _neighbor_matrix(species, pos, h, cutoff):
    """Brute-force neighbor matrix within `cutoff` (minimum image):
    (species_j, dist, mask) [n, k]."""
    side = np.diag(h)
    d = pos[:, None, :] - pos[None, :, :]
    d -= side * np.round(d / side)
    r = np.sqrt(np.einsum("ijk,ijk->ij", d, d))
    np.fill_diagonal(r, np.inf)
    within = r < cutoff
    k = int(within.sum(1).max())
    idx = np.argsort(~within, axis=1, kind="stable")[:, :k]
    mask = np.take_along_axis(within, idx, 1)
    dist = np.where(mask, np.take_along_axis(r, idx, 1), 1e6)
    return species[idx], dist, mask


def test_repulsion_column_matches_the_plain_form(efv):
    """The step kernel's repulsion column (its plain version) equals
    `repulsion_energies` over a brute-force neighbor matrix, and the
    port's `repulsion_energies` equals the JAX package's."""
    _, _, p = efv
    spec = p["pot"].spec
    species, pos = p["species"], p["pos"].numpy()
    sp_j, dist, mask = _neighbor_matrix(species, pos, p["h"],
                                        spec.repulsion.cutoff)
    no_ghost = np.zeros(len(species), bool)
    got = trep.repulsion_energies(
        spec.repulsion, torch.tensor(species), torch.tensor(sp_j),
        torch.tensor(dist), torch.tensor(mask), torch.tensor(no_ghost),
        torch.tensor(np.zeros_like(mask))).numpy()
    jspec = jrep.RepulsionSpec.for_symbols(tzoo.ANI2X_SYMBOLS, cutoff=5.1)
    ref = np.asarray(jrep.repulsion_energies(
        jspec, jnp.asarray(species), jnp.asarray(sp_j), jnp.asarray(dist),
        jnp.asarray(mask), jnp.asarray(no_ghost),
        jnp.asarray(np.zeros_like(mask))))
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=0)
    grid, bins, asn, sections = p["state"][:4]
    _, erep, _, _ = tasn.aev_asn_fused(
        spec.aev, grid, bins, asn, p["pos"], p["box"], sections, p["caps"],
        repulsion=spec.repulsion)
    assert got.min() > 0
    np.testing.assert_allclose(erep.numpy(), got, rtol=1e-12, atol=0)


@pytest.mark.parametrize("cutoff_fn", ["smooth", "cosine", "none"])
def test_repulsion_energies_match_jax(cutoff_fn):
    """Seeded neighbor matrices with padding, a ghost center and
    distances beyond the cutoff, for each envelope."""
    rng = np.random.default_rng(11)
    n, k = 24, 10
    species = rng.integers(0, 7, n)
    species[3] = -1
    sp_j = rng.integers(0, 7, (n, k))
    dist = rng.uniform(0.6, 6.0, (n, k))
    mask = rng.random((n, k)) < 0.8
    ghost_c = np.zeros(n, bool)
    ghost_c[5] = True
    ghost_j = rng.random((n, k)) < 0.2
    kw = dict(cutoff=5.1, cutoff_fn=cutoff_fn)
    tspec = trep.RepulsionSpec.for_symbols(tzoo.ANI2X_SYMBOLS, **kw)
    jspec = jrep.RepulsionSpec.for_symbols(tzoo.ANI2X_SYMBOLS, **kw)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    args = (species, sp_j, dist, mask, ghost_c, ghost_j)
    got = trep.repulsion_energies(tspec, *map(torch.tensor, args)).numpy()
    ref = np.asarray(jrep.repulsion_energies(jspec, *map(jnp.asarray, args)))
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=1e-300)
    assert got[3] == 0 and got[5] == 0 and got.max() > 0


def test_compact_columns_mlp_matches_the_full_aev(efv):
    """`col_idx`: an MLP on the compact AEV columns (first layer's weight
    rows gathered) equals the MLP on the full AEV with zeros elsewhere,
    and the JAX package's compact MLP."""
    _, _, p = efv
    spec, params, counts = p["pot"].spec, p["pot"].params, p["counts"]
    grid, bins, asn, sections = p["state"][:4]
    chans = tasn.present_channels(spec.aev, p["caps"], sections)
    col_idx = tuple([s * 16 + j for s, _ in sections for j in range(16)]
                    + [112 + ch0 + j for ch0 in chans for j in range(32)])
    rng = np.random.default_rng(5)
    n = len(p["species"])
    compact = rng.standard_normal((n, len(col_idx))) * 0.3
    full = np.zeros((n, spec.aev.aev_length))
    full[:, col_idx] = compact
    got = tnet.atomic_energies_sorted(spec.net, params, counts,
                                      torch.tensor(compact), col_idx=col_idx)
    want = tnet.atomic_energies_sorted(spec.net, params, counts,
                                       torch.tensor(full))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)
    jparams = jax.tree.map(jnp.asarray, [[{k: v.numpy() for k, v in l.items()}
                                          for l in layers]
                                         for layers in params])
    jspec = jzoo.ani2x(num_models=1, dtype=jnp.float64).spec.net
    ref = jnet.atomic_energies_sorted(jspec, jparams, counts,
                                      jnp.asarray(compact), col_idx=col_idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_npz_carries_the_repulsion_term(tmp_path):
    """The .npz format carries the repulsion metadata both ways."""
    jpot = jzoo.ani2x(num_models=1, dtype=jnp.float64, repulsion=True)
    jzoo.save_potential(tmp_path / "jax.npz", jpot)
    pot = tzoo.load_potential(tmp_path / "jax.npz", dtype=torch.float64,
                              device="cpu")
    assert (dataclasses.asdict(pot.spec.repulsion)
            == dataclasses.asdict(jpot.spec.repulsion))
    assert pot.spec.repulsion == tzoo.ani2x(
        num_models=1, device="cpu", repulsion=True).spec.repulsion
    tzoo.save_potential(tmp_path / "port.npz", pot)
    back = jzoo.load_potential(tmp_path / "port.npz", dtype=jnp.float64)
    assert back.spec.repulsion == jpot.spec.repulsion


def test_unported_asn_uses_raise(efv):
    """What raises around the asn path, and what no longer does: the
    repulsion term on the `pallas_full` engine (only the asn engine and
    the mirror carry it) and an engine name the port does not know raise;
    the default engine is the mirror, the `xla` hybrid is an engine; a box
    too small for the asn engine's 3x3x3 grid of side Rcr + skin runs the
    mirror engine, as the JAX package's does, and warns that the engine it
    was asked for did not run; the roll path's energies
    with a repulsion spec raise."""
    _, _, p = efv
    species = torch.tensor(p["species"])
    kw = dict(potential=p["pot"], species=p["species"],
              masses=np.ones(len(species)), device="cpu",
              dtype=torch.float64)
    with pytest.raises(ValueError, match="repulsion"):
        tlat.Simulation(nbr=tlat.NeighborConfig(cutoff=5.1),
                        engine="pallas_full", **kw)
    with pytest.raises(ValueError, match="engine"):
        tlat.Simulation(nbr=tlat.NeighborConfig(cutoff=5.1), engine="roll",
                        **kw)
    assert tlat.Simulation(nbr=tlat.NeighborConfig(cutoff=5.1),
                           **kw).engine == "mirror"
    with pytest.warns(RuntimeWarning, match="'xla' cannot run"):
        sim = tlat.Simulation(nbr=tlat.NeighborConfig(cutoff=5.1),
                              engine="xla", **kw)
    assert sim.engine == "mirror"  # repulsion: the mirror
    sim = tlat.Simulation(nbr=tlat.NeighborConfig(cutoff=5.1, skin=3.0),
                          engine="pallas_asn", **kw)
    assert sim.engine == "pallas_asn"
    # 24 A box: no 3x3x3 grid of side 5.1 + 3.0
    with pytest.warns(RuntimeWarning, match="'pallas_asn' cannot run"):
        state = sim.init_state(p["pos"].numpy(), p["box"])
    assert sim.engine == "mirror" and sim._roll_grid is None
    assert bool(torch.isfinite(state.force).all())
    with pytest.raises(ValueError, match="repulsion"):
        tpotmod.atomic_energies_roll(p["pot"], species, p["pos"], p["box"],
                                     None, None, p["counts"])
