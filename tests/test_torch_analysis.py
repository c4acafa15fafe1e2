"""The port's analysis modules against the JAX package's:
lammps_ani_torch/analysis/wham.py and analysis/fragments.py.

WHAM on the synthetic windows of tests/test_analysis.py (a quadratic PMF
sampled through 13 harmonic windows) and on periodic windows: bin centers,
PMF (its NaN bins in the same places) and free energies to 1e-10.
`bond_pairs`, `fragments` and `formula_time_series` exactly equal to the
JAX functions' on WATER30 (with and without the box, and with a molecule
across a face) and on the 1,440-atom combustion mixture built by the
port's examples/combustion `prepare_system` (and two jittered frames of it),
on the CPU path of the port's device code.
"""

import numpy as np
import pytest
import torch

from lammps_ani_tpu.analysis import fragments as jfrag
from lammps_ani_tpu.analysis import wham as jwham
from lammps_ani_torch.analysis import fragments as tfrag
from lammps_ani_torch.analysis import wham as twham
from lammps_ani_torch.examples.combustion import prepare_system

from . import fixtures


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def windows(periodic):
    rng = np.random.default_rng(3)
    a, k, temp = 8.0, 40.0, 300.0
    kt = twham.BOLTZ * temp
    centers = np.linspace(-1.2, 1.2, 13)
    if periodic:
        centers = np.linspace(-np.pi, np.pi, 12, endpoint=False)
    samples = []
    for c in centers:
        var = kt / (a + k)
        s = rng.normal(k * c / (a + k), np.sqrt(var), 4000)
        if periodic:
            s = (s + np.pi) % (2 * np.pi) - np.pi
        samples.append(s)
    return samples, centers, k, temp


@pytest.mark.parametrize("periodic", [None, 2 * np.pi])
def test_wham_matches_jax(periodic):
    samples, centers, k, temp = windows(periodic)
    got = twham.wham(samples, centers, k=k, temp=temp, n_bins=60,
                     periodic=periodic)
    ref = jwham.wham(samples, centers, k=k, temp=temp, n_bins=60,
                     periodic=periodic)
    assert twham.BOLTZ == jwham.BOLTZ
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-10, equal_nan=True)
    if periodic is None:
        x, pmf, _ = got
        ref_pmf = 0.5 * 8.0 * x ** 2
        ref_pmf -= ref_pmf[np.nanargmin(pmf)]
        sel = np.abs(x) < 0.8
        assert np.nanmax(np.abs(pmf[sel] - ref_pmf[sel])) < 0.15


def mixture():
    d = prepare_system.build(n_ch4=160, seed=7)
    return d.species, d.positions, d.box_h


def water_across_face():
    pos = fixtures.WATER30_POS.copy()
    pos[:3] += np.array([3.98 - pos[0, 0], 0.0, 0.0])
    pos[1:3, 0] -= np.where(pos[1:3, 0] >= 4.0, 8.0, 0.0)
    return fixtures.WATER30_SPECIES, pos, fixtures.WATER30_BOX


SYSTEMS = {
    "water30": lambda: (fixtures.WATER30_SPECIES, fixtures.WATER30_POS,
                        fixtures.WATER30_BOX),
    "water30_open": lambda: (fixtures.WATER30_SPECIES,
                             fixtures.WATER30_POS, None),
    "water30_across_face": water_across_face,
    "mixture1440": mixture,
}


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_bond_pairs_and_fragments_match_jax(name):
    species, pos, h = SYSTEMS[name]()
    got = tfrag.bond_pairs(species, pos, h, device="cpu")
    assert got == jfrag.bond_pairs(species, pos, h)
    assert got == sorted(got) and all(i < j for i, j in got)
    labels, formulas = tfrag.fragments(species, pos, h, device="cpu")
    jlabels, jformulas = jfrag.fragments(species, pos, h)
    np.testing.assert_array_equal(labels, jlabels)
    assert formulas == jformulas
    if name.startswith("water"):
        assert formulas == {"H2O1": 10}
    else:
        assert formulas == {"H4C1": 160, "O2": 320}


def test_formula_time_series_matches_jax():
    species, pos, h = mixture()
    rng = np.random.default_rng(1)
    frames = [pos, pos + 0.3 * rng.standard_normal(pos.shape),
              pos + 0.6 * rng.standard_normal(pos.shape)]
    got = tfrag.formula_time_series(frames, species, h, device="cpu")
    assert got == jfrag.formula_time_series(frames, species, h)
    assert len(got) == 3 and got[0] == {"H4C1": 160, "O2": 320}
    assert got[2] != got[0]
    assert tfrag.DEFAULT_CUTOFFS == jfrag.DEFAULT_CUTOFFS
