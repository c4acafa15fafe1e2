"""Import hygiene of the PyTorch port: `lammps_ani_torch` and
`chip_smoke.py` import neither JAX nor the JAX package, set the precision
policy at import, and refuse to fall back to the CPU when the card is
asked for and absent.
"""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "lammps_ani_torch"
FORBIDDEN = ("jax", "jaxlib", "lammps_ani_tpu")

_BLOCKED_IMPORT = r"""
import importlib, json, pkgutil, sys
for name in ("jax", "jaxlib", "lammps_ani_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
import lammps_ani_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    lammps_ani_torch.__path__, "lammps_ani_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke
import torch
loaded = sorted(m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "lammps_ani_tpu")))
print(json.dumps({
    "modules": names, "loaded_forbidden": loaded,
    "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
    "cudnn_tf32": torch.backends.cudnn.allow_tf32,
    "precision": torch.get_float32_matmul_precision()}))
"""


def _run(code, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def blocked_import():
    proc = _run(_BLOCKED_IMPORT, ROOT)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_every_module_imports_with_jax_blocked(blocked_import):
    mods = set(blocked_import["modules"])
    for name in ("lammps_ani_torch.ops.aev_roll", "lammps_ani_torch.ops._build",
                 "lammps_ani_torch.ops.aev_asn",
                 "lammps_ani_torch.md.simulation",
                 "lammps_ani_torch.models.repulsion",
                 "lammps_ani_torch.models.zoo"):
        assert name in mods
    assert blocked_import["loaded_forbidden"] == []


def test_precision_policy_is_set_at_import(blocked_import):
    assert blocked_import["matmul_tf32"] is False
    assert blocked_import["cudnn_tf32"] is False
    assert blocked_import["precision"] == "highest"


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "chip_ab.py"]))
def test_no_source_imports_jax_or_the_jax_package(path):
    """Also imports inside functions, which an import run does not reach."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not set(roots) & set(FORBIDDEN), (path, ast.dump(node))


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """With no card, the entry points raise unless device="cpu" is
    passed; they never carry on silently on the CPU."""
    import lammps_ani_torch as tlat
    from lammps_ani_torch.models import zoo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.ani2x(num_models=1)
    pot = zoo.ani2x(num_models=1, device="cpu")
    assert pot.s0_l0_w.device.type == "cpu"
    nbr = tlat.NeighborConfig(cutoff=5.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlat.Simulation(potential=pot, species=[0, 3], masses=[1.0, 16.0],
                        nbr=nbr)


def test_chip_smoke_fails_without_a_card(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    it exits non-zero and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_ab_fails_without_a_card(monkeypatch, capsys):
    """The A/B timing script measures on the card only: with no card it
    exits non-zero and prints no result; without kernel names, its usage."""
    import chip_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_ab.main(["chip_ab.py", "here", "step_fused"]) == 1
    assert chip_ab.main(["chip_ab.py"]) == 2
    assert capsys.readouterr().out == ""
