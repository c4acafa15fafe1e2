"""The port's CLI on its `mesh_shape` route (lammps_ani_torch/run.py, the
JAX CLI's `_main_sharded`), on the CPU in f64 with `--device cpu`.

One WATER30 x 2^3 data file with velocities (240 atoms, a 16 A cube),
ANI-2x with one model, dt 0.2 fs, 4 steps, a rebuild every 2, thermo and
a DCD frame every 2, a restart at the end:

  * in process on `LocalMesh` (mesh 2 1 1): its thermo against the
    single-device route's on the same file (pe rtol 1e-12, the other
    columns as the engines agree: temp and ke 1e-10, press 1e-8);
  * under `torchrun --standalone --nproc_per_node 2` (one shard a rank,
    gloo): the thermo YAML, the final DCD frame and the restart equal to
    the `LocalMesh` run's (the frame and the restart's positions and
    velocities bit for bit, the thermo within 1e-12), printed and written
    by rank 0 alone;
  * a world size other than px * py * pz, and `minimize_first`, raise
    ValueErrors (the process group is destroyed after the first);
  * the `DomainSpec` the route builds equals the JAX package's
    `parallel.domain.auto_domain_spec` called at the port's neighbor
    radius max(cutoff, Rcr) + skin (ANI-1xnr: Rcr 5.2 > cutoff 5.1).
"""

import json
import os
import socket
import subprocess
import sys
from contextlib import redirect_stdout
from io import StringIO

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lammps_ani_tpu.parallel import domain as jdomain
from lammps_ani_torch import run as trun
from lammps_ani_torch.io import dump as tdump
from lammps_ani_torch.io import lammps_data as tld

from . import fixtures
from ._dist_workers import ROOT

STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_mesh")
    tile = tld.LammpsData(
        species=fixtures.WATER30_SPECIES.astype(np.int64),
        positions=fixtures.WATER30_POS, masses_by_type=fixtures.MASSES,
        box_bounds=np.array([[-4.0, 4.0]] * 3), tilt=np.zeros(3),
        velocities=0.002 * np.random.default_rng(3).standard_normal((30, 3)))
    tld.write_lammps_data(d / "water8.data", tld.replicate(tile, 2, 2, 2))
    return d


def cfg_of(d, tag, **kw):
    cfg = {"data": str(d / "water8.data"), "model": "ani2x",
           "num_models": 1, "precision": "double", "dt": 0.2,
           "steps": STEPS, "rebuild_every": 2, "thermo_every": 2,
           "ensemble": "nve", "dump": str(d / f"{tag}.dcd"),
           "dump_format": "dcd", "dump_every": 2,
           "log": str(d / f"{tag}.yaml"), "restart": str(d / f"{tag}.npz"),
           "device": "cpu"}
    cfg.update(kw)
    return cfg


def argv(cfg):
    res = []
    for k, v in cfg.items():
        res += [f"--{k}"] + ([str(x) for x in v] if isinstance(v, list)
                             else [str(v)])
    return res


def thermo_lines(out):
    return [line for line in out.splitlines() if line.startswith("  ")]


@pytest.fixture(scope="module")
def runs(data_file):
    """{arm: (stdout, thermo rows, DCD frames, restart arrays)}: the
    torchrun arm started first, the in-process arms while it runs."""
    d = data_file
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    # a JSON config: torchrun's own parser takes a flag that abbreviates
    # one of its options (--log)
    (d / "pg.json").write_text(json.dumps(cfg_of(d, "pg",
                                                 mesh_shape=[2, 1, 1])))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "lammps_ani_torch.run",
           str(d / "pg.json")]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        outs = {}
        for tag, kw in (("local", {"mesh_shape": [2, 1, 1]}),
                        ("single", {})):
            buf = StringIO()
            with redirect_stdout(buf):
                trun.main(argv(cfg_of(d, tag, **kw)))
            outs[tag] = buf.getvalue()
        outs["pg"] = proc.communicate(timeout=300)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, outs.get("pg", "")[-3000:]
    res = {}
    for tag, out in outs.items():
        with np.load(d / f"{tag}.npz") as z:
            restart = {k: z[k] for k in z.files}
        res[tag] = (out, tdump.read_thermo_yaml(d / f"{tag}.yaml"),
                    tdump.read_dcd(d / f"{tag}.dcd"), restart)
    return res


def test_local_mesh_matches_the_single_device_route(runs):
    _, local, _, _ = runs["local"]
    _, single, _, _ = runs["single"]
    assert local["step"] == single["step"] == [2.0, 4.0]
    np.testing.assert_allclose(local["pe"], single["pe"], rtol=1e-12)
    for key in ("ke", "temp", "etotal"):
        np.testing.assert_allclose(local[key], single[key], rtol=1e-10)
    np.testing.assert_allclose(local["press"], single["press"], rtol=0,
                               atol=1e-8 * np.abs(single["press"]).max())


def test_torchrun_matches_local_mesh(runs):
    out, rows, frames, restart = runs["pg"]
    l_out, l_rows, l_frames, l_restart = runs["local"]
    assert rows.keys() == l_rows.keys() and rows["step"] == l_rows["step"]
    for key in rows:
        np.testing.assert_allclose(rows[key], l_rows[key], rtol=1e-12,
                                   atol=0)
    assert frames.shape == l_frames.shape == (2, 240, 3)
    assert np.array_equal(frames[-1], l_frames[-1])
    assert restart.keys() == l_restart.keys()
    for key in ("pos", "vel", "species", "mass", "box_h", "step"):
        assert np.array_equal(restart[key], l_restart[key]), key


def test_torchrun_prints_on_rank_0_only(runs):
    out, _, _, _ = runs["pg"]
    l_out, _, _, _ = runs["local"]
    assert len(thermo_lines(out)) == len(thermo_lines(l_out)) == 2
    assert out.count("# Performance:") == 1
    assert out.count("#         step") == 1


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("case", ["world_size", "minimize_first"])
def test_refusals(data_file, monkeypatch, case):
    """Under a torchrun environment of one rank: mesh 2 1 1 names both
    sizes, and the group is gone after it; `minimize_first` is refused
    before a group is made."""
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "localhost"),
                 ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(k, v)
    if case == "world_size":
        cfg, match = cfg_of(data_file, "ws", mesh_shape=[2, 1, 1]), \
            r"\(2, 1, 1\) has 2 shards but the process group has 1 ranks"
    else:
        cfg, match = cfg_of(data_file, "mf", mesh_shape=[1, 1, 1],
                            minimize_first=True), \
            "minimize_first is not supported with mesh_shape"
    with pytest.raises(ValueError, match=match):
        trun.main(argv(cfg))
    assert not dist.is_initialized()


def test_domain_spec_matches_jax(data_file):
    """The route's capacities: the JAX `auto_domain_spec` at the port's
    rlist (7.2 A for ANI-1xnr at cutoff 5.1, skin 2.0), and k_max from
    the JAX CLI's density formula at that radius."""
    cfg = trun.load_config(argv(cfg_of(data_file, "spec", model="ani1x_nr",
                                       mesh_shape=[2, 1, 1])))
    dsim, data, box = trun.build(cfg)
    assert dsim.rlist == pytest.approx(7.2)
    box_h = box.h.numpy()
    density = data.n_atoms / abs(np.linalg.det(box_h))
    k_max = -(-int(4.19 * 7.2 ** 3 * density * 1.3 + 8) // 8) * 8
    ref = jdomain.auto_domain_spec(data.n_atoms, box_h, (2, 1, 1),
                                   dsim.rlist, k_max=k_max)
    got = dsim.dspec
    assert (got.mesh_shape, got.n_cap, got.halo_cap, got.mig_cap,
            got.k_max) == (ref.mesh_shape, ref.n_cap, ref.halo_cap,
                           ref.mig_cap, ref.k_max)
    assert dsim.sizing()["backend"] == "local"
