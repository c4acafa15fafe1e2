"""The port's staged early-earth campaign
(lammps_ani_torch/examples/early_earth/run_stages.py) over a process
group on the CPU: its `main` under `torchrun --standalone
--nproc_per_node 2` (one shard a rank, gloo, f32, `"device": "cpu"` in
the config) against `run_campaign` on `LocalMesh` in this process, on
tests/test_torch_examples_stages.py's system and config (mesh (2,1,1),
two stages of 3 steps at 300 K and 500 K).

Bit for bit: both restarts (positions, velocities, the chain, the layout
and every other array) and every thermo column but the pressure (pe, ke,
etotal, temp, vol, density: each shard's kinetic sums, added over two
ranks, are the same bits in either order). The pressure's virial is the
strain gradient, summed over the ranks after each differentiates its own
shard's energy, where `LocalMesh` differentiates both shards' at once:
the same terms added in another order, held within 1e-6 relative (a few
f32 roundings); the dynamics do not read it under NoseHoover. Rank 0
alone prints.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lammps_ani_torch.examples.early_earth import run_stages as rs
from lammps_ani_torch.io import dump as tdump

from ._dist_workers import ROOT
from .test_torch_examples_stages import STAGES, config, npz, system


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The torchrun arm started first, the `LocalMesh` campaign while it
    runs."""
    d = tmp_path_factory.mktemp("stages_dist")
    system(d)
    (d / "pg.json").write_text(json.dumps(config(d, "pg")))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         "lammps_ani_torch.examples.early_earth.run_stages",
         str(d / "pg.json")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        local = rs.run_campaign(config(d, "local"), device="cpu",
                                log=lambda line: None)
        out = proc.communicate(timeout=300)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-3000:]
    return d, out, local


def test_rank_0_alone_prints(runs):
    _, out, _ = runs
    assert out.count("# stage 0: T=300.0 K, 3 steps") == 1
    assert out.count("# stage 1: T=500.0 K, 3 steps") == 1
    assert out.count("# invariants OK: etotal finite, 245 atoms "
                     "conserved") == 1
    assert out.count("# final fragments:") == 1


def test_thermo_equals_local_mesh(runs):
    d, _, local = runs
    pg, lo = (tdump.read_thermo_yaml(d / f"{t}.yaml")
              for t in ("pg", "local"))
    assert pg["step"] == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    assert pg.keys() == lo.keys()
    for key in pg:
        if key != "press":
            assert pg[key] == lo[key], key
    np.testing.assert_allclose(pg["press"], lo["press"], rtol=1e-6, atol=0)
    rows = [r for stage in local.rows for r in stage]
    assert [r["pe"] for r in rows] == lo["pe"]


def test_restarts_and_final_positions_equal_local_mesh(runs):
    d, _, local = runs
    for i in range(len(STAGES)):
        a, b = npz(d / f"pg.stage{i}.npz"), npz(d / f"local.stage{i}.npz")
        assert a.keys() == b.keys()
        for k in a:
            if k != "__meta__":
                assert np.array_equal(a[k], b[k]), (i, k)
    assert np.array_equal(npz(d / "pg.stage1.npz")["pos"],
                          local.dsim.gather(local.state, "pos"))
