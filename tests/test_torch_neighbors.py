"""Port neighbor machinery vs the JAX package, exactly.

lammps_ani_torch.ops.{neighbors,cell_list,cell_roll} against
lammps_ani_tpu.ops.{neighbors,cell_list,cell_roll} on WATER30 replicated
2x2x2 (240 atoms, 16 A box), f64, same inputs. Index structures must be
identical; neighbor matrices are compared as sets per row (closest-first
ties may order differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ani_tpu.ops import cell_list as jcl
from lammps_ani_tpu.ops import cell_roll as jcr
from lammps_ani_tpu.ops import neighbors as jnb
from lammps_ani_torch.ops import cell_list as tcl
from lammps_ani_torch.ops import cell_roll as tcr
from lammps_ani_torch.ops import neighbors as tnb

from .fixtures import MASSES, WATER30_BOX, WATER30_ORIGIN, WATER30_POS
from .fixtures import WATER30_SPECIES

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: with several test processes on one machine, each
    with a thread per core, the threads wait on one another at every
    operation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def water_system(rep=2, jitter=0.0, seed=0):
    """(species, positions, box_h, origin, masses) of WATER30 replicated
    rep^3 times (optionally jittered by a seeded normal)."""
    shifts = [np.array([i, j, k]) @ WATER30_BOX for i in range(rep)
              for j in range(rep) for k in range(rep)]
    pos = np.concatenate([WATER30_POS + s for s in shifts])
    if jitter:
        pos = pos + jitter * np.random.default_rng(seed).standard_normal(
            pos.shape)
    species = np.tile(WATER30_SPECIES, rep ** 3)
    return (species, pos, WATER30_BOX * rep, WATER30_ORIGIN.copy(),
            MASSES[species])


def boxes(h, origin):
    return (jnb.Box(h=jnp.asarray(h), origin=jnp.asarray(origin)),
            tnb.Box(h=torch.tensor(h), origin=torch.tensor(origin)))


@pytest.fixture(scope="module")
def system():
    species, pos, h, origin, _ = water_system(jitter=0.3)
    jbox, tbox = boxes(h, origin)
    jpos = jnb.wrap_positions(jnp.asarray(pos), jbox)
    tpos = tnb.wrap_positions(torch.tensor(pos), tbox)
    return dict(species=species, pos=pos, h=h, jbox=jbox, tbox=tbox,
                jpos=jpos, tpos=tpos)


def test_wrap_positions_exact(system):
    np.testing.assert_array_equal(np.asarray(system["jpos"]),
                                  system["tpos"].numpy())


@pytest.mark.parametrize("cutoff,capacity", [(4.5, 512), (7.1, 4096),
                                             (7.1, 100)])
def test_build_ghosts_exact(system, cutoff, capacity):
    shifts = jnb.image_shifts(1)
    jg = jnb.build_ghosts(system["jpos"], system["jbox"], cutoff, capacity,
                          shifts)
    tg = tnb.build_ghosts(system["tpos"], system["tbox"], cutoff, capacity,
                          tnb.image_shifts(1))
    for k in ("src", "shift", "mask", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, k)),
                                      getattr(tg, k).numpy(), err_msg=k)


def _row_sets(idx, mask):
    return [set(np.asarray(r)[np.asarray(m)].tolist())
            for r, m in zip(idx, mask)]


def _nlists(system, cutoff, k_max, cells):
    shifts = jnb.image_shifts(1)
    jg = jnb.build_ghosts(system["jpos"], system["jbox"], cutoff, 4096,
                          shifts)
    tg = tnb.build_ghosts(system["tpos"], system["tbox"], cutoff, 4096,
                          shifts)
    if cells:
        jgrid = jcl.CellGrid.for_box(system["h"], cutoff, 64)
        tgrid = tcl.CellGrid.for_box(system["h"], cutoff, 64)
        assert jgrid == jcl.CellGrid(**vars(tgrid))
        jn = jcl.build_neighbor_matrix_cells(system["jpos"], system["jbox"],
                                             cutoff, k_max, jg, grid=jgrid)
        tn = tcl.build_neighbor_matrix_cells(system["tpos"], system["tbox"],
                                             cutoff, k_max, tg, grid=tgrid)
    else:
        jn = jnb.build_neighbor_matrix_brute(system["jpos"], system["jbox"],
                                             cutoff, k_max, jg)
        tn = tnb.build_neighbor_matrix_brute(system["tpos"], system["tbox"],
                                             cutoff, k_max, tg)
    return jn, tn


@pytest.mark.parametrize("cells", [False, True], ids=["brute", "cells"])
@pytest.mark.parametrize("cutoff", [4.5, 5.1])
def test_neighbor_matrix_sets(system, cells, cutoff):
    jn, tn = _nlists(system, cutoff, 96, cells)
    assert int(jn.max_count) == int(tn.max_count)
    assert _row_sets(jn.idx, jn.mask) == _row_sets(tn.idx.numpy(),
                                                   tn.mask.numpy())
    _, jd = jnb.neighbor_displacements(system["jpos"], system["jbox"], jn)
    _, td = tnb.neighbor_displacements(system["tpos"], system["tbox"], tn)
    np.testing.assert_allclose(np.sort(np.asarray(jd), axis=1),
                               np.sort(td.numpy(), axis=1), rtol=1e-14)


@pytest.mark.parametrize("cells", [False, True], ids=["brute", "cells"])
def test_neighbor_matrix_overflow_count(system, cells):
    """k_max below the true degree: both report the same true degree."""
    jn, tn = _nlists(system, 5.1, 8, cells)
    assert int(jn.max_count) == int(tn.max_count) > 8


@pytest.mark.parametrize("side,cap", [(4.5, 16), (5.1, 24), (4.5, 8)])
def test_build_bins_exact(system, side, cap):
    jgrid = jcr.RollGrid.for_box(system["h"], side, cap)
    tgrid = tcr.RollGrid.for_box(system["h"], side, cap)
    assert jgrid.ncells == tgrid.ncells and jgrid.cap == tgrid.cap
    jb = jcr.build_bins(jgrid, system["jpos"],
                        jnp.asarray(system["species"]), system["jbox"])
    tb = tcr.build_bins(tgrid, system["tpos"],
                        torch.tensor(system["species"]), system["tbox"])
    for k in ("cell", "slot", "species_grid", "mask_grid", "inv",
              "count_max"):
        np.testing.assert_array_equal(np.asarray(getattr(jb, k)),
                                      getattr(tb, k).numpy(), err_msg=k)


def test_roll_grid_too_small_is_none(system):
    assert tcr.RollGrid.for_box(system["h"], 6.0, 16) is None
    assert jcr.RollGrid.for_box(system["h"], 6.0, 16) is None
