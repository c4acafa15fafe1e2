"""Ensemble weights drawn from a seed, as the configuration states them.

One generator on the run's device, seeded with the configuration's
`weights.seed` (the model is the configuration's: every run serves the
same one, and `--seed` varies the trajectory), and one draw of standard
normals for every weight and bias of every species' network, split and
scaled: w ~ N(0, 1) sqrt(2 / d_in) x damp (`damp_out` on the
output layer), b ~ N(0, 1) x `bias`. The same arrays go to the program
(its factory's `params=`) and to the reference.
"""

from __future__ import annotations

import math

import torch


def layer_dims(cfg: dict, species: int) -> list[tuple[int, int]]:
    """(d_in, d_out) of each layer of one species' network (the full AEV
    in, one energy out)."""
    a = cfg["aev"]
    ns = len(cfg["symbols"])
    n_rad = len(a["eta_r"]) * len(a["shf_r"])
    n_ang = (len(a["eta_a"]) * len(a["zeta"]) * len(a["shf_a"])
             * len(a["shf_z"]))
    dims = (ns * n_rad + ns * (ns + 1) // 2 * n_ang,
            *cfg["hidden"][species], 1)
    return list(zip(dims[:-1], dims[1:]))


def draw(cfg: dict, device, dtype=torch.float32):
    """species -> layers -> {"w": [m, d_in, d_out], "b": [m, d_out]}."""
    seed = cfg["weights"]["seed"]
    m = int(cfg["num_models"])
    w_cfg = cfg["weights"]
    shapes = []
    for s in range(len(cfg["symbols"])):
        dims = layer_dims(cfg, s)
        for li, (d_in, d_out) in enumerate(dims):
            damp = w_cfg["damp_out"] if li == len(dims) - 1 else w_cfg["damp"]
            shapes.append((s, li, (m, d_in, d_out),
                           math.sqrt(2.0 / d_in) * damp, (m, d_out)))
    total = sum(math.prod(w) + math.prod(b) for *_, w, _, b in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    z = torch.randn(total, generator=gen, device=device, dtype=dtype)
    params = [[None] * len(cfg["hidden"][s]) + [None]
              for s in range(len(cfg["symbols"]))]
    at = 0
    for s, li, w_shape, scale, b_shape in shapes:
        nw, nb = math.prod(w_shape), math.prod(b_shape)
        params[s][li] = {
            "w": z[at:at + nw].view(w_shape) * scale,
            "b": z[at + nw:at + nw + nb].view(b_shape) * w_cfg["bias"]}
        at += nw + nb
    return params
