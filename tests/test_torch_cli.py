"""The port's CLI (lammps_ani_torch/run.py) against the JAX package's
(lammps_ani_tpu/run.py), on the CPU in f64.

Both CLIs read one WATER30 data file with velocities (written by JAX's
writer) and one model file (JAX's synthetic ANI-1xnr, 1 model, saved by
JAX's `save_potential`), with `precision double`, dt 0.1 fs, 8 steps, a
rebuild every 2 steps, thermo every 2 steps and a DCD frame every 4; the
port's with `device cpu`, and under nve through
`python -m lammps_ani_torch.run config.json`:

  * under nve, nvt and npt: the same thermo YAML to rtol 1e-10 (each
    column against its largest magnitude), the same DCD frame count and
    frames (to f32 rounding), and the same `Performance:` line format;
  * `minimize_first` on WATER30's first molecule, where FIRE reaches the
    CLI's ftol (1e-4) before its 1000 steps (250 with a rebuild every 10),
    so the exit on max |F| is taken: the same steps, with fmax and pe to
    rtol 1e-10;
  * `mesh_shape` with `minimize_first` raises the JAX CLI's ValueError in
    both CLIs (the route itself: tests/test_torch_cli_mesh.py).
"""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lammps_ani_tpu import run as jrun
from lammps_ani_tpu.io import dump as jdump
from lammps_ani_tpu.io import lammps_data as jld
from lammps_ani_tpu.models import zoo as jzoo
from lammps_ani_torch import run as trun
from lammps_ani_torch.io import dump as tdump

from . import fixtures

ROOT = Path(__file__).resolve().parents[1]
PERF = re.compile(r"^# Performance: \d+\.\d{4} ns/day, \d+\.\d{3} "
                  r"timesteps/s, \d+\.\d{4} Matom-step/s$", re.M)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    data = jld.LammpsData(
        species=fixtures.WATER30_SPECIES, positions=fixtures.WATER30_POS,
        masses_by_type=fixtures.MASSES,
        box_bounds=np.array([[-4.0, 4.0]] * 3), tilt=np.zeros(3),
        velocities=0.002 * np.random.default_rng(3).standard_normal((30, 3)))
    jld.write_lammps_data(d / "water.data", data)
    jld.write_lammps_data(d / "water3.data", jld.LammpsData(
        species=data.species[:3], positions=data.positions[:3],
        masses_by_type=data.masses_by_type, box_bounds=data.box_bounds,
        tilt=data.tilt, velocities=data.velocities[:3]))
    jzoo.save_potential(d / "model.npz",
                        jzoo.ani1xnr(num_models=1, dtype=jnp.float64))
    return d


def args(d, tag, ensemble, **kw):
    out = {"data": str(d / "water.data"), "model": str(d / "model.npz"),
           "num_models": 1, "precision": "double", "dt": 0.1, "steps": 8,
           "rebuild_every": 2, "thermo_every": 2, "ensemble": ensemble,
           "tdamp": 20.0, "pdamp": 100.0, "dump": str(d / f"{tag}.dcd"),
           "dump_format": "dcd", "dump_every": 4,
           "log": str(d / f"{tag}.yaml")}
    out.update(kw)
    return out


def argv(cfg):
    res = []
    for k, v in cfg.items():
        res += [f"--{k}"] + ([str(x) for x in v] if isinstance(v, list)
                             else [str(v)])
    return res


def run_jax(cfg, capsys):
    capsys.readouterr()
    jrun.main(argv(cfg))
    return capsys.readouterr().out


def run_port(cfg, capsys):
    capsys.readouterr()
    trun.main(argv({**cfg, "device": "cpu"}))
    return capsys.readouterr().out


def thermo_close(got, ref):
    assert got.keys() == ref.keys() and got["step"] == ref["step"]
    for k in got:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert np.abs(g - r).max() <= 1e-10 * max(np.abs(r).max(), 1e-300), k


@pytest.mark.parametrize("ensemble", ["nve", "nvt", "npt"])
def test_cli_matches_jax(inputs, capsys, ensemble):
    d = inputs
    jout = run_jax(args(d, f"jax_{ensemble}", ensemble), capsys)
    tcfg = args(d, f"port_{ensemble}", ensemble)
    if ensemble == "nve":
        # the module entry point on a JSON config
        path = d / "port_nve.json"
        path.write_text(json.dumps({**tcfg, "device": "cpu"}))
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        tout = subprocess.run(
            [sys.executable, "-m", "lammps_ani_torch.run", str(path)],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
            check=True).stdout
    else:
        tout = run_port(tcfg, capsys)
    jrows = jdump.read_thermo_yaml(d / f"jax_{ensemble}.yaml")
    trows = tdump.read_thermo_yaml(d / f"port_{ensemble}.yaml")
    assert trows["step"] == [2.0, 4.0, 6.0, 8.0]
    thermo_close(trows, jrows)
    jf = jdump.read_dcd(d / f"jax_{ensemble}.dcd")
    tf = tdump.read_dcd(d / f"port_{ensemble}.dcd")
    assert tf.shape == jf.shape == (2, 30, 3)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-5)
    assert len(PERF.findall(tout)) == len(PERF.findall(jout)) == 1
    # the same thermo lines on the screen, to their 4 decimals
    tlines = [l for l in tout.splitlines() if l.startswith("  ")]
    jlines = [l for l in jout.splitlines() if l.startswith("  ")]
    assert len(tlines) == len(jlines) == 4
    assert tout.splitlines()[0] == jout.splitlines()[0]


def test_minimize_first_matches_jax(inputs, capsys):
    d = inputs
    cfg = args(d, "min", "nve", steps=2, dump=None, log=None,
               minimize_first=True, rebuild_every=10,
               data=str(d / "water3.data"))
    cfg = {k: v for k, v in cfg.items() if v is not None}

    def info(out):
        line = next(l for l in out.splitlines()
                    if l.startswith("# minimize: "))
        return ast.literal_eval(line[len("# minimize: "):])

    ji = info(run_jax(cfg, capsys))
    ti = info(run_port(cfg, capsys))
    assert ti["steps"] == ji["steps"] < 1000 and ti["fmax"] < 1e-4
    assert ti["fmax"] == pytest.approx(ji["fmax"], rel=1e-10)
    assert ti["pe"] == pytest.approx(ji["pe"], rel=1e-10)


def test_mesh_shape_raises(inputs):
    cfg = args(inputs, "mesh", "nve", mesh_shape=[1, 1, 1],
               minimize_first=True)
    msg = "minimize_first is not supported with mesh_shape"
    with pytest.raises(ValueError, match=msg):
        jrun.main(argv(cfg))
    with pytest.raises(ValueError, match=msg):
        trun.main(argv({**cfg, "device": "cpu"}))
