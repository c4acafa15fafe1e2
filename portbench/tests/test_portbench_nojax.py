"""No run of the benchmark loads JAX or the JAX package: the run's own
check (`run.forbidden_modules`, top-level names compared whole) and a
fresh process that imports every module a run imports."""

import ast
import glob
import os
import subprocess
import sys

from portbench import run as runmod

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)


def test_top_level_names_compared_whole():
    mods = {"lammps_ani_torch": 1, "lammps_ani_torch.md.simulation": 1,
            "jaxtyping": 1, "flaxen": 1, "lammps_ani_tpuish": 1,
            "torch.jax": 1}
    assert runmod.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "jaxlib": 1, "flax.linen": 1,
                 "lammps_ani_tpu.md": 1})
    assert runmod.forbidden_modules(mods) == [
        "flax.linen", "jax.numpy", "jaxlib", "lammps_ani_tpu.md"]


def test_a_run_imports_no_jax():
    code = (
        "import portbench.run as r, portbench.check, portbench.control, "
        "portbench.md, portbench.trace, portbench.system, portbench.weights, "
        "portbench.counts.work, portbench.counts.neighbors, "
        "portbench.metrics\n"
        "import lammps_ani_torch, lammps_ani_torch.md.simulation, "
        "lammps_ani_torch.models.zoo, lammps_ani_torch.ops.aev_asn\n"
        "print(r.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sources_name_no_jax():
    for path in glob.glob(os.path.join(PB, "**", "*.py"), recursive=True):
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in runmod.FORBIDDEN, (path, n)
