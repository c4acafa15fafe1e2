"""The plain reference against the port's plain path (CPU, f64).

The reference (portbench/reference/) is written from the published
functional form and the configuration files; here it is held against the
port's own plain PyTorch path (the mirror engine) on the same inputs and
weights: energy, forces and virial, and the integrator's steps with the
Langevin noise replayed and with a Nose-Hoover chain."""

import copy
import json
import os

import pytest
import torch

from portbench import check, md, system as sysmod, weights
from portbench.reference import ani

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _cfg(name):
    with open(os.path.join(ROOT, "configs", f"{name}.json")) as fh:
        return json.load(fh)


def _traffic(name):
    with open(os.path.join(ROOT, "workloads", f"{name}.json")) as fh:
        return json.load(fh)


def _small_system(config, traffic):
    cfg, tr = _cfg(config), copy.deepcopy(_traffic(traffic))
    if tr["system"]["kind"] == "tile":
        tr["system"]["replicate"] = [2, 2, 2]
    else:
        tr["system"]["molecules"][0]["count"] = 20
        tr["system"]["molecules"][1]["count"] = 40
        tr["system"]["replicate"] = [1, 1, 1]
    return cfg, tr, sysmod.build(tr, cfg)


def _f64(params):
    return [[{k: v.double() for k, v in layer.items()} for layer in layers]
            for layers in params]


def _port_sim(cfg, tr, system, params, integrator=None, rebuild_every=4):
    import lammps_ani_torch as lat
    from lammps_ani_torch.models import zoo

    pot = getattr(zoo, cfg["port"]["factory"])(
        num_models=cfg["num_models"], params=_f64(params),
        dtype=torch.float64, device="cpu", **cfg["port"]["kwargs"])
    nbr = lat.NeighborConfig(cutoff=5.1, skin=2.0, k_max=128,
                             ghost_capacity=4096, rebuild_every=rebuild_every)
    sim = lat.Simulation(potential=pot, species=system.species,
                         masses=system.masses, nbr=nbr, dt=tr["md"]["dt"],
                         dtype=torch.float64, device="cpu",
                         integrator=integrator)
    box = lat.Box(h=torch.diag(torch.tensor(system.lengths)),
                  origin=torch.tensor(system.origin))
    return sim, sim.init_state(system.positions, box,
                               temp=tr["md"]["init_temp"], seed=3)


@pytest.mark.parametrize("config,traffic", [
    ("ani2x-xtb-1m", "water-langevin-24-centred"),
    ("ani1xnr-8m", "combustion-nvt-4-centred")])
def test_reference_matches_port_plain_path(config, traffic):
    cfg, tr, system = _small_system(config, traffic)
    params = weights.draw(cfg, torch.device("cpu"))
    sim, st = _port_sim(cfg, tr, system, params)
    assert sim.engine == "mirror"
    model = ani.Model(cfg, params, torch.float64, "cpu")
    e, f, w = ani.energy_forces_virial(
        model, torch.as_tensor(system.species),
        torch.as_tensor(system.positions), torch.as_tensor(system.lengths))
    fp = torch.as_tensor(sim.forces_input_order(st))
    assert abs(float(st.pe - e)) <= 1e-9 * abs(float(e))
    assert float((fp - f).abs().max()) <= 1e-10 * float(f.abs().max())
    assert float((st.virial - w).abs().max()) <= 1e-10 * float(
        w.abs().max())


def test_cell_list_pairs_match_every_pair():
    """The cell-list branch of the pair search (more than 2,048 atoms) finds
    the pairs that the all-pairs branch finds."""
    cfg = _cfg("ani2x-xtb-1m")
    tr = copy.deepcopy(_traffic("water-langevin-24-centred"))
    tr["system"]["replicate"] = [5, 5, 5]
    system = sysmod.build(tr, cfg)
    pos = torch.as_tensor(system.positions)
    lengths = torch.as_tensor(system.lengths)
    i, j = ani.pair_list(pos, lengths, 5.2)
    assert len(pos) > 2048
    got = set(zip(i.tolist(), j.tolist()))
    d = ani.min_image(pos[None] - pos[:, None], lengths)
    r = (d * d).sum(-1).sqrt()
    r.fill_diagonal_(1e9)
    ii, jj = torch.nonzero(r < 5.2, as_tuple=True)
    assert got == set(zip(ii.tolist(), jj.tolist()))


@pytest.mark.parametrize("config,traffic", [
    ("ani2x-xtb-1m", "water-langevin-24-centred"),
    ("ani1xnr-8m", "combustion-nvt-4-centred")])
def test_check_follows_port_steps(config, traffic):
    """check.py's reading of a chunk of the port (Langevin with its noise
    replayed; Nose-Hoover with its chain) agrees with the reference that
    follows it, in f64, to rounding."""
    from lammps_ani_torch.md import integrate

    cfg, tr, system = _small_system(config, traffic)
    cfg = {**cfg, "dtype": "float64"}
    params = weights.draw(cfg, torch.device("cpu"))
    gen = torch.Generator(device="cpu").manual_seed(5)
    integ = md.integrator(tr["md"], gen)
    sim, st0 = _port_sim(cfg, tr, system, params, integ)
    gen_state = gen.get_state()
    st1, _ = sim.run(st0, 4)
    chunk = md.Chunk(before=st0, gen_state=gen_state, regrew=False, after=st1)
    case = check.case_of(md.Run(sim, st1, gen), tr, system, chunk)
    got, _ = check.readings(cfg, params, case, torch.device("cpu"))
    assert isinstance(integ, (integrate.Langevin, integrate.NoseHoover))
    assert case.steps == 4
    for k in ("force_max", "force_q90", "virial", "velocity_max"):
        assert got[k] < 1e-9, (k, got)
    assert got["position_max"] < 1e-11, got
