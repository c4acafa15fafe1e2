"""Model zoo: the ANI-2x and ANI-1xnr factories, weight transfer and
serialization.

Port of lammps_ani_tpu/models/zoo.py. Synthetic weights are drawn with a
`torch.Generator` (the same damped-Kaiming scale as the JAX package; the
draws differ from `jax.random`'s). Weights cross between the packages
through `params_from_numpy` or the shared `.npz` format of
`save_potential` / `load_potential`.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .._device import resolve_device
from . import aev as aevmod
from . import networks as netmod
from . import potential as potmod
from . import repulsion as repmod

ANI2X_SYMBOLS = ("H", "C", "N", "O", "S", "F", "Cl")
ANI1X_SYMBOLS = ("H", "C", "N", "O")


def init_network_params(spec: netmod.NetworkSpec, num_models: int,
                        generator: torch.Generator, dtype=torch.float32,
                        device="cpu"):
    """Synthetic ensemble weights: w ~ N(0, 1) * sqrt(2 / d_in) * damp
    (damp 0.05 on the output layer, 0.5 elsewhere), drawn in f32 on the
    CPU so f32 and f64 potentials hold the same weights; zero biases."""
    params = []
    for s in range(spec.num_species):
        dims = spec.layer_dims(s)
        layers = []
        for li, (d_in, d_out) in enumerate(dims):
            damp = 0.05 if li == len(dims) - 1 else 0.5
            w = torch.randn((num_models, d_in, d_out), generator=generator,
                            dtype=torch.float32) * float(
                                np.float32(np.sqrt(2.0 / d_in) * damp))
            layers.append({
                "w": w.to(device=device, dtype=dtype),
                "b": torch.zeros((num_models, d_out), dtype=dtype,
                                 device=device)})
        params.append(layers)
    return params


def params_from_numpy(params, dtype=torch.float64, device="cpu"):
    """The JAX package's parameter pytree (species -> layers ->
    {"w": [m, in, out], "b": [m, out]}, as numpy arrays or anything
    np.asarray takes) -> the port's tensors."""
    return [[{k: torch.as_tensor(np.array(layer[k]), dtype=dtype,
                                 device=device) for k in ("w", "b")}
             for layer in layers] for layers in params]


def _ani2x_spec(repulsion: bool = False) -> potmod.ANISpec:
    aev_spec = aevmod.ani2x_aev_spec()
    net_spec = netmod.NetworkSpec(aev_length=aev_spec.aev_length,
                                  hidden=netmod.ANI2X_HIDDEN)
    rep = (repmod.RepulsionSpec.for_symbols(ANI2X_SYMBOLS, cutoff=5.1,
                                            cutoff_fn="smooth")
           if repulsion else None)
    return potmod.ANISpec(
        aev=aev_spec, net=net_spec,
        shifter=netmod.EnergyShifter(netmod.ANI2X_SELF_ENERGIES),
        repulsion=rep, symbols=ANI2X_SYMBOLS)


def _ani1xnr_spec(repulsion: bool = True) -> potmod.ANISpec:
    aev_spec = aevmod.ani1x_aev_spec()
    net_spec = netmod.NetworkSpec(aev_length=aev_spec.aev_length,
                                  hidden=netmod.ANI1X_HIDDEN)
    rep = (repmod.RepulsionSpec.for_symbols(ANI1X_SYMBOLS, cutoff=5.1,
                                            cutoff_fn="smooth")
           if repulsion else None)
    return potmod.ANISpec(
        aev=aev_spec, net=net_spec,
        shifter=netmod.EnergyShifter(netmod.ANI1X_SELF_ENERGIES),
        repulsion=rep, symbols=ANI1X_SYMBOLS)


def _potential(spec, num_models, seed, dtype, device, params):
    """`spec` with `params` (moved to the device and dtype) or synthetic
    weights drawn from `seed`."""
    dev = resolve_device(device)
    if params is None:
        g = torch.Generator(device="cpu").manual_seed(seed)
        params = init_network_params(spec.net, num_models, g, dtype, dev)
    else:
        params = [[{k: v.to(device=dev, dtype=dtype)
                    for k, v in layer.items()} for layer in layers]
                  for layers in params]
    return potmod.ANIPotential(spec, params)


def ani2x(num_models: int = 8, seed: int = 0, dtype=torch.float32,
          device=None, params=None,
          repulsion: bool = False) -> potmod.ANIPotential:
    """ANI-2x at its published widths (7 species, AEV 1008).
    `repulsion=True` adds the XTB core-repulsion term (cutoff 5.1,
    smooth envelope), which the reference's ANI-2x leaves out but which
    keeps MD under synthetic weights in a liquid-like regime. `params=None`
    draws synthetic weights from `seed`. Runs on the card unless `device`
    says otherwise."""
    return _potential(_ani2x_spec(repulsion), num_models, seed, dtype,
                      device, params)


def ani1xnr(num_models: int = 8, seed: int = 1, dtype=torch.float32,
            params=None, device=None) -> potmod.ANIPotential:
    """ANI-1xnr: the ANI-1x AEV (4 species HCNO, Rcr 5.2, zeta 32, AEV
    384) and networks, with the XTB repulsion term always on (cutoff 5.1,
    smooth envelope). `params=None` draws synthetic weights from `seed`.
    Runs on the card unless `device` says otherwise."""
    return _potential(_ani1xnr_spec(), num_models, seed, dtype, device,
                      params)


all_models = {
    "ani2x": ani2x,
    "ani1x_nr": ani1xnr,
}


def save_potential(path, pot: potmod.ANIPotential):
    """Spec + weights to one .npz (the JAX package's format)."""
    spec = pot.spec
    meta = {
        "aev": {k: getattr(spec.aev, k) for k in (
            "radial_cutoff", "angular_cutoff", "eta_r", "shf_r",
            "eta_a", "zeta", "shf_a", "shf_z", "num_species")},
        "net": {"aev_length": spec.net.aev_length,
                "hidden": spec.net.hidden,
                "celu_alpha": spec.net.celu_alpha},
        "self_energies": spec.shifter.self_energies,
        "symbols": spec.symbols,
        "repulsion": None if spec.repulsion is None else {
            "alpha": spec.repulsion.alpha, "zeff": spec.repulsion.zeff,
            "cutoff": spec.repulsion.cutoff, "k_f": spec.repulsion.k_f,
            "cutoff_fn": spec.repulsion.cutoff_fn},
    }
    arrays = {"__meta__": np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8)}
    for s, layers in enumerate(pot.params):
        for li, layer in enumerate(layers):
            arrays[f"s{s}_l{li}_w"] = layer["w"].detach().cpu().numpy()
            arrays[f"s{s}_l{li}_b"] = layer["b"].detach().cpu().numpy()
    np.savez(path, **arrays)


def load_potential(path, dtype=torch.float32,
                   device=None) -> potmod.ANIPotential:
    dev = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        rep = None
        if meta.get("repulsion") is not None:
            r = meta["repulsion"]
            rep = repmod.RepulsionSpec(
                alpha=tuple(r["alpha"]), zeff=tuple(r["zeff"]),
                cutoff=r["cutoff"], k_f=r["k_f"], cutoff_fn=r["cutoff_fn"])
        aev_spec = aevmod.AEVSpec(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in meta["aev"].items()})
        net_spec = netmod.NetworkSpec(
            aev_length=meta["net"]["aev_length"],
            hidden=tuple(tuple(h) for h in meta["net"]["hidden"]),
            celu_alpha=meta["net"]["celu_alpha"])
        params = []
        for s in range(net_spec.num_species):
            layers = []
            li = 0
            while f"s{s}_l{li}_w" in z:
                layers.append({
                    k: torch.as_tensor(z[f"s{s}_l{li}_{k}"], dtype=dtype,
                                       device=dev) for k in ("w", "b")})
                li += 1
            params.append(layers)
    spec = potmod.ANISpec(
        aev=aev_spec, net=net_spec,
        shifter=netmod.EnergyShifter(tuple(meta["self_energies"])),
        repulsion=rep, symbols=tuple(meta["symbols"]))
    return potmod.ANIPotential(spec, params)
