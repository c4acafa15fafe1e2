"""Checkpoint and restart.

Port of lammps_ani_tpu/io/restart.py, in the same format: one .npz (no
pickle) with the JAX package's keys and FORMAT_VERSION, atom arrays in
the caller's original order: positions, velocities, box, step, `rng`,
species, masses and the thermostat and barostat chains. Model weights
are not in it; they live with the model file.

The port's state has no PRNG key: its `Langevin` draws from a
`torch.Generator` (the device's default generator where it was given
none). `rng` holds that generator's state (`get_state()`), so a Langevin
run resumed on the same device continues the same stream; without a
Langevin integrator it is empty. A restart written by the JAX package
loads with positions, velocities, box, step and both chains exact, but
its `rng` is a JAX key (uint32 [2]) that cannot seed a torch generator:
under Langevin the port then keeps its own generator and says so with a
RuntimeWarning.

The port adds four keys the JAX package does not read: `order` (the
engine's atom order), `force`, `pe` and `virial` (the state's), and the
engine's sizing (`Simulation.sizing`) in the metadata. `load_restart`
restores them where the engine is the one that wrote the file, so on one
device a resumed run is bit for bit the run it continues (the same atom
order, shapes and first half kick). The state takes the file's positions
as they are (a step wraps them at its rebuild).
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import torch

from ..md import integrate
from ..md.state import BarostatState, MDState, ThermostatState
from ..ops.neighbors import Box

FORMAT_VERSION = 1


def _langevin_generator(sim):
    """The generator the Langevin integrator draws from (the device's
    default where it was given none); None without Langevin."""
    lg = sim.integrator
    if not isinstance(lg, integrate.Langevin):
        return None
    if lg.generator is not None:
        return lg.generator
    dev = sim.device
    if dev.type == "cuda":
        return torch.cuda.default_generators[
            torch.cuda.current_device() if dev.index is None else dev.index]
    return torch.default_generator


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_restart(path, sim, state: MDState, extra: dict | None = None):
    """Write a restart file for (sim, state)."""
    g = _langevin_generator(sim)
    arrays = {
        "pos": sim.positions_input_order(state),
        "vel": sim.velocities_input_order(state),
        "box_h": _np(state.box.h),
        "box_origin": _np(state.box.origin),
        "step": np.asarray(state.step, np.int32),
        "rng": (g.get_state().numpy() if g is not None
                else np.zeros(0, np.uint8)),
        "species": sim.species_np[sim.inv_order],
        "masses": _np(sim.masses)[sim.inv_order],
        "order": sim.order,
        "force": sim.forces_input_order(state),
        "pe": _np(state.pe),
        "virial": _np(state.virial),
    }
    if state.thermostat is not None:
        arrays["ts_eta"] = _np(state.thermostat.eta)
        arrays["ts_eta_dot"] = _np(state.thermostat.eta_dot)
    if state.barostat is not None:
        arrays["bs_omega"] = _np(state.barostat.omega)
        arrays["bs_eta"] = _np(state.barostat.omega_chain.eta)
        arrays["bs_eta_dot"] = _np(state.barostat.omega_chain.eta_dot)
    meta = {"version": FORMAT_VERSION, "dt": sim.dt, "n_atoms": sim.n_atoms,
            "extra": extra or {}, "sizing": sim.sizing()}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)


def load_restart(path, sim) -> MDState:
    """The MDState of a restart file, for `sim` built with the same
    potential and species (the port's or the JAX package's file)."""
    t = dict(dtype=sim.dtype, device=sim.device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError(f"restart format {meta.get('version')}, "
                             f"expected {FORMAT_VERSION}")
        if meta["n_atoms"] != sim.n_atoms:
            raise ValueError(
                f"restart has {meta['n_atoms']} atoms, sim {sim.n_atoms}")
        box = Box(h=torch.as_tensor(z["box_h"]).to(**t),
                  origin=torch.as_tensor(z["box_origin"]).to(**t))
        own = "order" in z.files
        state = sim.init_state(z["pos"], box, vel=z["vel"],
                               order=z["order"] if own else None)
        # the positions as the state held them (init_state wraps them)
        state = state.replace(pos=torch.as_tensor(z["pos"][sim.order]).to(**t))
        if own and meta.get("sizing", {}).get("engine") == sim.engine:
            sim.restore_sizing(meta["sizing"])
            state = state.replace(
                force=torch.as_tensor(z["force"][sim.order]).to(**t),
                pe=torch.as_tensor(z["pe"]).to(**t),
                virial=torch.as_tensor(z["virial"]).to(**t))
        ts = state.thermostat
        if "ts_eta" in z.files and ts is not None:
            ts = ThermostatState(eta=torch.as_tensor(z["ts_eta"]).to(**t),
                                 eta_dot=torch.as_tensor(
                                     z["ts_eta_dot"]).to(**t))
        bs = state.barostat
        if "bs_omega" in z.files and bs is not None:
            bs = BarostatState(
                omega=torch.as_tensor(z["bs_omega"]).to(**t),
                omega_chain=ThermostatState(
                    eta=torch.as_tensor(z["bs_eta"]).to(**t),
                    eta_dot=torch.as_tensor(z["bs_eta_dot"]).to(**t)))
        g = _langevin_generator(sim)
        if g is not None:
            rng = z["rng"]
            if rng.dtype == np.uint8 and rng.size == g.get_state().numel():
                g.set_state(torch.from_numpy(rng.copy()))
            else:
                warnings.warn(
                    f"restart {path}: its rng ({rng.dtype} {rng.shape}) is "
                    "not a torch generator state of this device (a JAX PRNG "
                    "key, or another device's): the Langevin integrator "
                    "keeps its own generator", RuntimeWarning, stacklevel=2)
        return state.replace(step=int(z["step"]), thermostat=ts,
                             barostat=bs)
