"""The port's system generators (lammps_ani_torch/examples/combustion/
prepare_system.py, early_earth/generate.py) against the JAX package's
example scripts (examples/combustion/prepare_system.py,
examples/early_earth/generate.py), and the two public names of
ops/neighbors.py the port took last (`Box.orthorhombic`,
`estimate_k_max`) against the JAX functions.

  * `build` (160 and 40 CH4; 480 waters) gives the JAX scripts' arrays bit
    for bit: species, positions, masses, box and tilt.
  * Each `main` writes the file its JAX script writes with the same
    arguments, byte for byte after the writer's comment line (which names
    the package), and prints the same line.
  * `generate.build(12000)` is examples/early_earth/early_earth_50k.data:
    49,000 atoms, the species equal, the box and positions within the
    file's printed precision (10 significant digits: 5e-9 A below 100 A),
    and the port's writer gives the file's bytes after its comment line.
"""

import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ani_tpu.ops import neighbors as jnb
from lammps_ani_torch.examples.combustion import prepare_system
from lammps_ani_torch.examples.early_earth import generate
from lammps_ani_torch.io.lammps_data import read_lammps_data, write_lammps_data
from lammps_ani_torch.ops import neighbors as tnb

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = {"prepare_system": ROOT / "examples" / "combustion"
           / "prepare_system.py",
           "generate": ROOT / "examples" / "early_earth" / "generate.py"}
PORTS = {"prepare_system": prepare_system, "generate": generate}
FIELDS = ("species", "positions", "masses_by_type", "box_bounds", "tilt")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scripts():
    """The JAX scripts as modules (their `main` stays unrun)."""
    mods = {}
    for name, path in SCRIPTS.items():
        spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    return mods


def body(path) -> bytes:
    """A data file's bytes after its first (comment) line."""
    return Path(path).read_bytes().split(b"\n", 1)[1]


@pytest.mark.parametrize("name,n", [("prepare_system", 160),
                                    ("prepare_system", 40),
                                    ("generate", 480)])
def test_build_matches_the_jax_script(scripts, name, n):
    got, ref = PORTS[name].build(n), scripts[name].build(n)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("name,n", [("prepare_system", 160),
                                    ("generate", 480)])
def test_main_writes_the_jax_scripts_file(tmp_path, name, n):
    out = {}
    for arm in ("jax", "port"):
        (tmp_path / arm).mkdir()
        if arm == "jax":
            proc = subprocess.run(
                [sys.executable, str(SCRIPTS[name]), str(n), "sys.data"],
                cwd=tmp_path / arm, capture_output=True, text=True,
                timeout=120, env=dict(os.environ, JAX_PLATFORMS="cpu"))
            assert proc.returncode == 0, proc.stderr[-2000:]
            printed = proc.stdout
        else:
            buf = io.StringIO()
            cwd = os.getcwd()
            os.chdir(tmp_path / arm)
            try:
                with contextlib.redirect_stdout(buf):
                    PORTS[name].main([str(n), "sys.data"])
            finally:
                os.chdir(cwd)
            printed = buf.getvalue()
        out[arm] = (printed, tmp_path / arm / "sys.data")
    assert out["port"][0] == out["jax"][0]
    first = Path(out["port"][1]).read_text().split("\n", 1)[0]
    assert first == "# generated by lammps_ani_torch"
    assert body(out["port"][1]) == body(out["jax"][1])


def test_build_12000_is_the_committed_50k_system(tmp_path):
    path = ROOT / "examples" / "early_earth" / "early_earth_50k.data"
    ref = read_lammps_data(path, fast=False)
    got = generate.build(12000)
    assert got.n_atoms == ref.n_atoms == 49000
    assert np.array_equal(got.species, ref.species)
    assert np.abs(got.box_bounds - ref.box_bounds).max() <= 5e-9
    assert np.array_equal(got.masses_by_type, ref.masses_by_type)
    assert np.abs(got.positions).max() < 100.0
    assert np.abs(got.positions - ref.positions).max() <= 5e-9
    write_lammps_data(tmp_path / "ee.data", got)
    assert body(tmp_path / "ee.data") == body(path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_box_orthorhombic_matches_jax(dtype):
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]
    lengths, origin = (12.5, 8.25, 31.0), (-1.5, 0.25, 3.0)
    for args in ((lengths,), (lengths, origin)):
        got = tnb.Box.orthorhombic(*args, dtype=dtype, device="cpu")
        ref = jnb.Box.orthorhombic(*args, dtype=jdt)
        assert got.h.dtype == dtype and got.h.device.type == "cpu"
        assert np.array_equal(got.h.numpy(), np.asarray(ref.h))
        assert np.array_equal(got.origin.numpy(), np.asarray(ref.origin))
        assert float(got.volume) == float(ref.volume)


@pytest.mark.parametrize("density,cutoff,safety", [
    (0.1003, 5.2, 1.35), (0.0334, 7.1, 1.35), (0.0116, 6.2, 2.0),
    (0.05, 0.5, 1.0)])
def test_estimate_k_max_matches_jax(density, cutoff, safety):
    got = tnb.estimate_k_max(density, cutoff, safety)
    ref = jnb.estimate_k_max(density, cutoff, safety)
    assert type(got) is int and got == ref and got % 8 == 0
