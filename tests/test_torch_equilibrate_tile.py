"""The port's tile tool (lammps_ani_torch/tools/equilibrate_tile.py) on
the CPU: WATER30 written by the port's `write_lammps_data`, one Langevin
leg of 20 steps after FIRE, into `tmp_path`. The .npz has the keys and
shapes of the JAX tool's output (examples/benchmark/data/
equil_water30.npz), finite values, a box equal to the input's; nothing is
written under examples/, and the committed tile stays byte-identical.
"""

import hashlib
import pathlib

import numpy as np
import pytest
import torch

from lammps_ani_torch.io.lammps_data import LammpsData, write_lammps_data
from lammps_ani_torch.tools import equilibrate_tile

from . import fixtures

ROOT = pathlib.Path(__file__).resolve().parent.parent
TILE = ROOT / "examples" / "benchmark" / "data" / "equil_water30.npz"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree_digest():
    return {str(p): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((ROOT / "examples").rglob("*")) if p.is_file()}


def test_tool_writes_the_jax_tools_keys(tmp_path, capsys):
    data = LammpsData(species=fixtures.WATER30_SPECIES,
                      positions=fixtures.WATER30_POS,
                      masses_by_type=fixtures.MASSES,
                      box_bounds=np.stack([fixtures.WATER30_ORIGIN,
                                           fixtures.WATER30_ORIGIN + 8.0], 1),
                      tilt=np.zeros(3))
    write_lammps_data(tmp_path / "w30.data", data)
    before = tree_digest()
    out = tmp_path / "eq" / "tile.npz"
    equilibrate_tile.main([str(tmp_path / "w30.data"), str(out),
                           "--legs", "1", "--steps", "20", "--device", "cpu"])
    assert tree_digest() == before
    text = capsys.readouterr().out
    assert "FIRE:" in text and "leg 0:" in text
    with np.load(out) as got, np.load(TILE) as ref:
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            assert got[k].shape == ref[k].shape, k
            assert np.all(np.isfinite(got[k])), k
        np.testing.assert_array_equal(got["box_h"], np.diag([8.0] * 3))
        assert 100.0 < float(got["temp"]) < 2000.0


def test_tool_needs_the_output_path():
    with pytest.raises(SystemExit):
        equilibrate_tile.main(["only_the_data.data"])
