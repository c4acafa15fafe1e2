"""BENCHMARK.json, the configurations, traffic mixes and limits load and
validate; the systems are the sizes the cells state; the configurations'
constants are the port's."""

import json
import os
import re

import numpy as np
import pytest
import torch

from portbench import md, run as runmod, system as sysmod, weights

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _short(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_benchmark_json_shape():
    b = _bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["paths"] == ["portbench"]
    assert 1 <= len(b["command"]) <= 32 and all(map(_short, b["command"]))
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert list(c) == ["name", "source", "file", "reduced", "why"]
        assert NAME.match(c["name"]) and _short(c["source"])
        assert _short(c["why"]) and c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"]
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    used, pairs = set(), set()
    for w in b["workloads"]:
        assert list(w) == ["name", "config", "traffic", "chips", "why"]
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _short(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        assert os.path.exists(os.path.join(PB, "workloads",
                                           f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(PB, "limits", f"{w['name']}.json"))
    assert used == names
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _short(m["layer"])
        assert os.path.exists(os.path.join(PB, "metrics",
                                           f"{m['name']}.py"))
    all_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(all_names) == len(set(all_names))


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cell_loads_and_limits_lie_between_readings(cell):
    c = runmod.cell(cell)
    lim = c["limits"]
    assert lim["limits"]
    for k, v in lim["limits"].items():
        r = lim["readings"][k]
        assert r["lower"] < v < r["upper"] and r["upper"] >= 3 * r["lower"]
    assert c["traffic"]["md"]["cellroll"] is True
    assert "engine" not in c["traffic"]["md"]


SIZES = {"water-ani2x-415k-centred": 414720,
         "combustion-ani1xnr-92k-centred": 92160}


@pytest.mark.parametrize("cell,atoms", sorted(SIZES.items()))
def test_system_sizes(cell, atoms):
    c = runmod.cell(cell)
    s = sysmod.build(c["traffic"], c["cfg"])
    assert s.n_atoms == atoms
    assert s.positions.shape == (atoms, 3) and s.masses.shape == (atoms,)
    # centred: the box spans [-L/2, L/2), every atom inside it
    assert np.allclose(s.origin, -s.lengths / 2)
    assert (s.positions >= s.origin).all() and (
        s.positions < s.origin + s.lengths).all()


def test_combustion_placement_is_the_examples():
    from lammps_ani_torch.examples.combustion import prepare_system
    from lammps_ani_torch.io.lammps_data import replicate

    c = runmod.cell("combustion-ani1xnr-92k-centred")
    s = sysmod.build(c["traffic"], c["cfg"])
    d = replicate(prepare_system.build(), 4, 4, 4)
    # the same atoms, the box translated to be centred on the origin
    assert np.allclose(s.positions + s.lengths / 2, d.positions, rtol=0,
                       atol=1e-12)
    assert np.array_equal(s.species, d.species)
    assert np.allclose(s.lengths, np.diag(d.box_h))
    assert np.array_equal(s.masses, d.masses_by_type[d.species])


@pytest.mark.parametrize("config", [c["name"] for c in _bench()["configs"]])
def test_configuration_is_the_ports_model(config):
    from lammps_ani_torch.models import zoo

    with open(os.path.join(PB, "configs", f"{config}.json")) as fh:
        cfg = json.load(fh)
    pot = getattr(zoo, cfg["port"]["factory"])(
        num_models=1, device="cpu", **cfg["port"]["kwargs"])
    md.check_spec(cfg, pot.spec)
    params = weights.draw(cfg, torch.device("cpu"))
    assert len(params) == len(cfg["symbols"])
    for s, layers in enumerate(params):
        dims = weights.layer_dims(cfg, s)
        assert [tuple(layer["w"].shape) for layer in layers] == [
            (cfg["num_models"], a, b) for a, b in dims]
    bad = dict(cfg, hidden=[[1, 1, 1]] * len(cfg["hidden"]))
    with pytest.raises(ValueError):
        md.check_spec(bad, pot.spec)
