"""Import trained ANI weights from external formats, and export them.

Port of lammps_ani_tpu/models/loaders.py:

  * `load_torch_state_dict`: a torch `state_dict` with torchani's key
    names (a dict, a `torch.save`d file or a TorchScript archive, whose
    state_dict loads without torchani);
  * `load_neurochem`: a NeuroChem ensemble tree (.nnf / .wparam /
    .bparam), the published ANI weight format;
  * `export_torch_state_dict`: the weights as a torchani-named state_dict.

The weights are float32 on import, as the formats store them; each loader
takes the port's `dtype` and `device` (the card unless `device` says
otherwise). A layer shape that does not match the architecture raises a
ValueError.
"""

from __future__ import annotations

import re
import warnings
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from . import potential as potmod
from . import zoo

# torchani parameter naming:
#   Ensemble of ANIModel:  neural_networks.{m}.{S or idx}.layers.{i}.weight
#   common variants:       neural_networks.{m}.{S}.{i}.weight
#                          {m}.{S}.{i}.weight
#                          neural_networks.{S}.{i}.weight   (single model)
_KEY_RE = re.compile(
    r"^(?:model\.)?(?:neural_networks\.)?"
    r"(?:(\d+)\.)?"  # ensemble member
    r"([A-Z][a-z]?|\d+)\."  # species symbol or index
    r"(?:layers\.)?(\d+)\."  # sequential layer index
    r"(weight|bias)$"
)


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _parse_state_dict(sd, symbols):
    """dict of tensors or arrays -> params[species][layer]{w: [m, i, o],
    b: [m, o]} as float32 numpy arrays."""
    sym_to_idx = {s: i for i, s in enumerate(symbols)}
    entries = {}  # (member, species, seq, kind) -> np.ndarray
    for key, value in sd.items():
        m = _KEY_RE.match(key)
        if not m:
            continue
        member = int(m.group(1)) if m.group(1) is not None else 0
        sp = m.group(2)
        sp_idx = sym_to_idx[sp] if sp in sym_to_idx else int(sp)
        entries[(member, sp_idx, int(m.group(3)), m.group(4))] = _numpy(value)
    if not entries:
        raise ValueError("no recognizable ANI parameter keys found")
    members = sorted({k[0] for k in entries})
    species = sorted({k[1] for k in entries})
    params = []
    for s in range(max(species) + 1):
        seqs = sorted({k[2] for k in entries
                       if k[1] == s and k[3] == "weight"})
        layers = []
        for seq in seqs:
            ws, bs = [], []
            for member in members:
                w = entries[(member, s, seq, "weight")]
                b = entries.get((member, s, seq, "bias"))
                ws.append(w.T)  # torch [out, in] -> ours [in, out]
                bs.append(b if b is not None else np.zeros(w.shape[0]))
            layers.append({"w": np.stack(ws).astype(np.float32),
                           "b": np.stack(bs).astype(np.float32)})
        params.append(layers)
    return params


# each architecture's spec (ANI-1x: ANI-1xnr without the repulsion term)
_SPECS = {"ani2x": zoo._ani2x_spec, "ani1xnr": zoo._ani1xnr_spec,
          "ani1x": lambda: zoo._ani1xnr_spec(repulsion=False)}


def _check_shapes(net_spec, params):
    for s, layers in enumerate(params):
        want = net_spec.layer_dims(s)
        got = [(l["w"].shape[1], l["w"].shape[2]) for l in layers]
        if list(want) != got:
            raise ValueError(
                f"species {s}: layer dims {got} != architecture {want}")


def _build(arch, params, dtype, device) -> potmod.ANIPotential:
    """The architecture's potential holding `params` (numpy, checked
    against its layer dims)."""
    spec = _SPECS[arch]()
    _check_shapes(spec.net, params)
    dev = resolve_device(device)
    return potmod.ANIPotential(spec, [[{
        k: torch.as_tensor(layer[k]).to(device=dev, dtype=dtype)
        for k in ("w", "b")} for layer in layers] for layers in params])


def load_torch_state_dict(src, arch: str = "ani2x", dtype=torch.float32,
                          device=None) -> potmod.ANIPotential:
    """An ANIPotential from a torch state_dict.

    `src`: a dict of tensors or arrays, a path to a `torch.save`d
    state_dict, or a TorchScript archive (the reference's .pt export).
    `arch`: "ani2x" | "ani1x" | "ani1xnr" selects the AEV, the
    self-energies and the repulsion term."""
    if not isinstance(src, dict):
        path = str(src)
        try:
            with warnings.catch_warnings():
                # torch.jit.load is deprecated; TorchScript archives remain
                # the reference's export format
                warnings.simplefilter("ignore", DeprecationWarning)
                sd = torch.jit.load(path, map_location="cpu").state_dict()
        except RuntimeError:
            obj = torch.load(path, map_location="cpu", weights_only=False)
            sd = obj if isinstance(obj, dict) else obj.state_dict()
        src = sd
    params = _parse_state_dict(src, _SPECS[arch]().symbols)
    return _build(arch, params, dtype, device)


# --------------------------- NeuroChem format ---------------------------

def _read_neurochem_layer(dir_path: Path, layer: int):
    """NeuroChem stores each linear layer as wparam/bparam float32 blobs."""
    w = np.fromfile(dir_path / f"l{layer}.wparam", dtype="<f4")
    b = np.fromfile(dir_path / f"l{layer}.bparam", dtype="<f4")
    return w, b


def load_neurochem(root, symbols, arch: str = "ani1x",
                   num_models: int | None = None, dtype=torch.float32,
                   device=None) -> potmod.ANIPotential:
    """A NeuroChem ensemble tree: root/train{i}/networks/ANN-{S}/ with
    l{j}.wparam / l{j}.bparam per layer (published ANI models). Only
    arch "ani2x" picks ANI-2x; any other name gives ANI-1x."""
    root = Path(root)
    train_dirs = sorted(root.glob("train*"))
    if num_models is not None:
        train_dirs = train_dirs[:num_models]
    if not train_dirs:
        raise ValueError(f"no train* member directories under {root}")
    per_member = []
    for td in train_dirs:
        netdir = td / "networks"
        member = []
        for sym in symbols:
            sdir = (list(netdir.glob(f"ANN-{sym}*")) or [netdir / sym])[0]
            layers = []
            li = 0
            while (sdir / f"l{li}.wparam").exists():
                w, b = _read_neurochem_layer(sdir, li)
                d_out = len(b)
                layers.append((w.reshape(d_out, len(w) // d_out).T, b))
                li += 1
            member.append(layers)
        per_member.append(member)
    params = [[{"w": np.stack([pm[s][li][0] for pm in per_member]),
                "b": np.stack([pm[s][li][1] for pm in per_member])}
               for li in range(len(per_member[0][s]))]
              for s in range(len(symbols))]
    return _build("ani2x" if arch == "ani2x" else "ani1x", params, dtype,
                  device)


def export_torch_state_dict(pot: potmod.ANIPotential, path, symbols=None):
    """Write the weights as a torchani-named torch state_dict (.pt), on
    the CPU."""
    symbols = symbols or pot.spec.symbols
    sd = {}
    for s, layers in enumerate(pot.params):
        for li, layer in enumerate(layers):
            w = layer["w"].detach().cpu()
            b = layer["b"].detach().cpu()
            for member in range(w.shape[0]):
                prefix = f"neural_networks.{member}.{symbols[s]}.{2 * li}"
                sd[f"{prefix}.weight"] = w[member].T.contiguous()
                sd[f"{prefix}.bias"] = b[member].contiguous()
    torch.save(sd, str(path))
