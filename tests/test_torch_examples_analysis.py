"""The port's umbrella and analysis workflows
(lammps_ani_torch/examples/alanine_dipeptide_umbrella/run_umbrella.py and
analyze_umbrella.py, examples/combustion/analyze_traj.py) on the CPU:

  * `run_umbrella` on the reference water tile (tests/fixtures.py WATER30,
    through a data file) with a dihedral across two molecules (H 1, O 0,
    O 3, H 4), 3 windows of 8 steps, a sample every 4: its samples equal
    a direct `bias.run_windows` call with the same arguments bit for bit,
    and its npz holds the JAX script's keys (`centers`, `w0` ... `w2`);
  * `analyze_umbrella` on synthetic periodic windows in that npz layout:
    the PMF and free energies against the JAX `wham` with the JAX script's
    arguments within 1e-12, and the printed rows equal to the JAX script's
    (examples/alanine-dipeptide-umbrella/analyze_umbrella.py);
  * `analyze_traj` on three frames of the 360-atom combustion mixture
    written by the port's `DCDWriter`: the printed rows equal to the JAX
    script's (examples/combustion/analyze_traj.py) at strides 1 and 2,
    and `formula_rows` equal to `analysis.fragments` on `read_dcd`'s
    frames.
"""

import contextlib
import functools
import io
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from lammps_ani_tpu.analysis import wham as jwham
from lammps_ani_torch.analysis import fragments as tfrag
from lammps_ani_torch.examples.alanine_dipeptide_umbrella import (
    analyze_umbrella, run_umbrella)
from lammps_ani_torch.examples.combustion import analyze_traj, prepare_system
from lammps_ani_torch.io import dump as tdump
from lammps_ani_torch.io.lammps_data import (LammpsData, read_lammps_data,
                                             write_lammps_data)
from lammps_ani_torch.md import bias
from lammps_ani_torch.models import zoo
from lammps_ani_torch.ops.neighbors import Box

from . import fixtures
from ._dist_workers import ROOT

PHI = (1, 0, 3, 4)
WINDOWS, STEPS, EVERY = 3, 8, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_script(path, *args, cwd):
    """The JAX example script's stdout."""
    proc = subprocess.run([sys.executable, str(path), *map(str, args)],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def test_run_umbrella_equals_run_windows(tmp_path):
    tile = LammpsData(species=fixtures.WATER30_SPECIES.astype(np.int64),
                      positions=fixtures.WATER30_POS,
                      masses_by_type=fixtures.MASSES,
                      box_bounds=np.array([[-4.0, 4.0]] * 3),
                      tilt=np.zeros(3))
    write_lammps_data(tmp_path / "w30.data", tile)
    out = tmp_path / "umbrella_samples.npz"
    centers, samples = run_umbrella.run_umbrella(
        tmp_path / "w30.data", phi=PHI, n_windows=WINDOWS,
        steps_per_window=STEPS, sample_every=EVERY, device="cpu", out=out)

    data = read_lammps_data(tmp_path / "w30.data")
    make = functools.partial(
        run_umbrella.make_sim, data, zoo.ani2x(num_models=1, device="cpu"),
        generator=torch.Generator().manual_seed(run_umbrella.SEED),
        device="cpu")
    ref = bias.run_windows(
        make, data.positions,
        Box.from_lammps(*data.box_bounds.ravel(), *data.tilt, device="cpu"),
        np.linspace(-np.pi, np.pi, WINDOWS, endpoint=False), k=40.0,
        cv_factory=lambda: bias.dihedral_cv(*PHI), steps_per_window=STEPS,
        sample_every=EVERY, seed=run_umbrella.SEED, periodic=2 * np.pi)
    assert len(samples) == WINDOWS
    for got, want in zip(samples, ref):
        assert got.shape == (STEPS // EVERY,) and np.isfinite(got).all()
        assert np.array_equal(got, want)
    with np.load(out) as z:
        assert set(z.files) == {"centers"} | {f"w{i}" for i in range(WINDOWS)}
        assert np.array_equal(z["centers"], centers)
        assert np.array_equal(centers, np.linspace(-np.pi, np.pi, WINDOWS,
                                                   endpoint=False))
        for i, s in enumerate(samples):
            assert np.array_equal(z[f"w{i}"], s)


def synthetic_windows(path, n_windows=12, n=3000, seed=3):
    """Periodic harmonic windows over a quadratic PMF (k 40, 300 K), in
    the npz layout of `run_umbrella`."""
    rng = np.random.default_rng(seed)
    a, k, kt = 8.0, 40.0, jwham.BOLTZ * 300.0
    centers = np.linspace(-np.pi, np.pi, n_windows, endpoint=False)
    windows = {}
    for i, c in enumerate(centers):
        s = rng.normal(k * c / (a + k), np.sqrt(kt / (a + k)), n)
        windows[f"w{i}"] = (s + np.pi) % (2 * np.pi) - np.pi
    np.savez(path, centers=centers, **windows)
    return centers, [windows[f"w{i}"] for i in range(n_windows)]


def test_analyze_umbrella_matches_jax(tmp_path):
    path = tmp_path / "umbrella_samples.npz"
    centers, samples = synthetic_windows(path)
    got = analyze_umbrella.pmf(path)
    ref = jwham.wham(samples, centers, k=40.0, temp=300.0,
                     periodic=2 * np.pi)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12, equal_nan=True)
    script = ROOT / "examples" / "alanine-dipeptide-umbrella" / \
        "analyze_umbrella.py"
    want = jax_script(script, path, cwd=tmp_path)
    assert printed(analyze_umbrella.main, [str(path)]) == want
    assert want.splitlines()[0] == "# phi_rad  pmf_kcal_mol"
    assert len(want.splitlines()) == 73


@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    """Three frames of the 360-atom mixture (jittered, one moved by a box
    length) in a DCD written by the port's `DCDWriter`, and its data
    file."""
    d = tmp_path_factory.mktemp("traj")
    data = prepare_system.build(40)
    write_lammps_data(d / "mix.data", data)
    rng = np.random.default_rng(5)
    w = tdump.DCDWriter(d / "mix.dcd", data.n_atoms, dt_fs=0.25, every=10)
    for step in range(3):
        pos = data.positions + rng.normal(0.0, 0.25 * step,
                                          data.positions.shape)
        if step == 2:
            pos[::7] += data.box_h[0]
        w.write_frame(10 * step, pos, data.species, data.box_h,
                      data.box_origin)
    w.close()
    return d


@pytest.mark.parametrize("stride", [1, 2])
def test_analyze_traj_prints_the_jax_scripts_rows(trajectory, stride):
    d = trajectory
    script = ROOT / "examples" / "combustion" / "analyze_traj.py"
    want = jax_script(script, d / "mix.dcd", d / "mix.data", stride, cwd=d)
    got = printed(analyze_traj.main, [str(d / "mix.dcd"),
                                      str(d / "mix.data"), str(stride),
                                      "--device", "cpu"])
    assert got == want
    assert len(want.splitlines()) == 1 + len(range(0, 3, stride))


def test_formula_rows_are_fragments_of_the_frames(trajectory):
    d = trajectory
    data = read_lammps_data(d / "mix.data")
    frames = tdump.read_dcd(d / "mix.dcd")
    rows = analyze_traj.formula_rows(d / "mix.dcd", d / "mix.data",
                                     device="cpu")
    assert [r[0] for r in rows] == [0, 1, 2]
    box_h = np.diag(data.box_bounds[:, 1] - data.box_bounds[:, 0])
    for (_, top), pos in zip(rows, frames):
        _, formulas = tfrag.fragments(data.species, pos, box_h, device="cpu")
        assert top == Counter(formulas).most_common(8)
    assert rows[0][1][0][0] in ("H4C1", "O2")
