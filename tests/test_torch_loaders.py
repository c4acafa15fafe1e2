"""The port's weight loaders (lammps_ani_torch/models/loaders.py) against
the JAX package's (lammps_ani_tpu/models/loaders.py).

  * A state_dict written by JAX's `export_torch_state_dict` loads into the
    port with every weight equal, and one written by the port loads into
    JAX likewise (ANI-2x and ANI-1xnr), under the architecture's spec.
  * Every key variant of `_KEY_RE` (the torchani Ensemble form, the
    `model.` prefix, `layers.`, members without `neural_networks.`, a single
    model without a member index, species as an index), from a dict and
    from a `torch.save`d file, loads as JAX loads it.
  * A NeuroChem tree written by the test (train{m}/networks/ANN-{S}/
    l{j}.wparam / bparam) loads in both packages to the same weights.
  * A layer of the wrong shape raises ValueError in both.
"""

import numpy as np
import pytest
import torch

from lammps_ani_tpu.models import loaders as jload
from lammps_ani_tpu.models import zoo as jzoo
from lammps_ani_torch.models import loaders as tload
from lammps_ani_torch.models import zoo as tzoo


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jpots():
    return {"ani2x": jzoo.ani2x(num_models=2),
            "ani1xnr": jzoo.ani1xnr(num_models=2)}


def leaves_t(pot):
    return [layer[k].numpy() for layers in pot.params for layer in layers
            for k in ("w", "b")]


def leaves_j(pot):
    return [np.asarray(layer[k]) for layers in pot.params
            for layer in layers for k in ("w", "b")]


def same_weights(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["ani2x", "ani1xnr"])
def test_state_dict_both_ways(tmp_path, jpots, arch):
    jpot = jpots[arch]
    jload.export_torch_state_dict(jpot, tmp_path / "jax.pt")
    tpot = tload.load_torch_state_dict(tmp_path / "jax.pt", arch=arch,
                                       device="cpu")
    same_weights(leaves_t(tpot), leaves_j(jpot))
    assert tpot.spec == tzoo.all_models[{"ani2x": "ani2x",
                                         "ani1xnr": "ani1x_nr"}[arch]](
        num_models=1, device="cpu").spec
    tload.export_torch_state_dict(tpot, tmp_path / "port.pt")
    jback = jload.load_torch_state_dict(tmp_path / "port.pt", arch=arch)
    same_weights(leaves_j(jback), leaves_j(jpot))


def variant_keys(m, sym, s, li, n_models):
    """Each spelling of one layer's key prefix that `_KEY_RE` takes."""
    out = {
        "ensemble": f"neural_networks.{m}.{sym}.{2 * li}",
        "model_layers": f"model.neural_networks.{m}.{sym}.layers.{2 * li}",
        "bare_member": f"{m}.{sym}.{2 * li}",
        "species_index": f"neural_networks.{m}.{s}.{2 * li}",
    }
    if n_models == 1:
        out["single_model"] = f"neural_networks.{sym}.{2 * li}"
    return out


@pytest.mark.parametrize("variant", ["ensemble", "model_layers",
                                     "bare_member", "species_index",
                                     "single_model"])
@pytest.mark.parametrize("as_file", [False, True])
def test_key_variants(tmp_path, jpots, variant, as_file):
    jpot = jpots["ani1xnr"]
    if variant == "single_model":
        jpot = jpot.select_models(1)
    n_models = jpot.num_models
    sd = {}
    for s, layers in enumerate(jpot.params):
        sym = jzoo.ANI1X_SYMBOLS[s]
        for li, layer in enumerate(layers):
            w, b = np.asarray(layer["w"]), np.asarray(layer["b"])
            for m in range(n_models):
                k = variant_keys(m, sym, s, li, n_models)[variant]
                sd[k + ".weight"] = torch.from_numpy(w[m].T.copy())
                sd[k + ".bias"] = torch.from_numpy(b[m].copy())
    src = sd
    if as_file:
        src = tmp_path / "sd.pt"
        torch.save(sd, str(src))
    tpot = tload.load_torch_state_dict(src, arch="ani1xnr", device="cpu")
    jref = jload.load_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, arch="ani1xnr")
    same_weights(leaves_t(tpot), leaves_j(jref))
    same_weights(leaves_t(tpot), leaves_j(jpot))


def test_neurochem_both(tmp_path, jpots):
    jpot = jpots["ani1xnr"]
    symbols = jzoo.ANI1X_SYMBOLS
    for m in range(2):
        for s, sym in enumerate(symbols):
            d = tmp_path / f"train{m}" / "networks" / f"ANN-{sym}"
            d.mkdir(parents=True)
            for li, layer in enumerate(jpot.params[s]):
                np.asarray(layer["w"][m]).T.astype("<f4").tofile(
                    d / f"l{li}.wparam")
                np.asarray(layer["b"][m]).astype("<f4").tofile(
                    d / f"l{li}.bparam")
    tpot = tload.load_neurochem(tmp_path, symbols, arch="ani1x",
                                device="cpu", dtype=torch.float64)
    jref = jload.load_neurochem(tmp_path, symbols, arch="ani1x")
    same_weights([x.astype(np.float32) for x in leaves_t(tpot)],
                 leaves_j(jref))
    assert tpot.spec.repulsion is None and jref.spec.repulsion is None
    assert tpot.params[0][0]["w"].dtype == torch.float64
    one = tload.load_neurochem(tmp_path, symbols, num_models=1, device="cpu")
    assert one.num_models == 1
    same_weights(leaves_t(one), leaves_j(jload.load_neurochem(
        tmp_path, symbols, num_models=1)))


def test_shape_mismatch_raises():
    sd = {"neural_networks.0.H.0.weight": np.zeros((7, 1008), np.float32),
          "neural_networks.0.H.0.bias": np.zeros(7, np.float32)}
    with pytest.raises(ValueError, match="layer dims"):
        tload.load_torch_state_dict(sd, arch="ani2x", device="cpu")
    with pytest.raises(ValueError):
        jload.load_torch_state_dict(sd, arch="ani2x")
    with pytest.raises(ValueError, match="no recognizable"):
        tload.load_torch_state_dict({"foo": np.zeros(3)}, device="cpu")
