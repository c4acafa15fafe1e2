"""Per-species MLP ensembles and the energy shifter.

Port of lammps_ani_tpu/models/networks.py. Parameters are the same
structure as the JAX package's pytree — a list over species of a list
over layers of {"w": [m, d_in, d_out], "b": [m, d_out]} — held as
tensors; the ensemble is a leading model axis of batched matmuls.
The matmuls stay `torch.matmul`, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..utils.profiling import sync

# Published ANI-2x per-element hidden-layer widths (torchani architecture).
ANI2X_HIDDEN = (
    (256, 192, 160),  # H
    (224, 192, 160),  # C
    (192, 160, 128),  # N
    (192, 160, 128),  # O
    (160, 128, 96),   # S
    (160, 128, 96),   # F
    (160, 128, 96),   # Cl
)

# Published ANI-1x per-element hidden-layer widths (also ANI-1xnr).
ANI1X_HIDDEN = (
    (160, 128, 96),   # H
    (144, 112, 96),   # C
    (128, 112, 96),   # N
    (128, 112, 96),   # O
)


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """Static network hyperparameters."""

    aev_length: int
    hidden: tuple[tuple[int, ...], ...]
    celu_alpha: float = 0.1

    @property
    def num_species(self) -> int:
        return len(self.hidden)

    def layer_dims(self, species: int) -> list[tuple[int, int]]:
        dims = (self.aev_length, *self.hidden[species], 1)
        return list(zip(dims[:-1], dims[1:]))


class _CELU(torch.autograd.Function):
    """celu(x) = max(x, 0) + alpha expm1(min(x, 0) / alpha), with the
    derivative exp(min(x, 0) / alpha) taken from the input. PyTorch's own
    celu backward works from the output and keeps only about 7 digits of
    it for negative inputs, even in f64; this one keeps them all, as JAX's
    derivative of the same formula does."""

    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(x)
        ctx.alpha = alpha
        return torch.nn.functional.celu(x, alpha=alpha)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, max=0.0) / ctx.alpha), None


def select_models(params, num_models: int | None):
    """The first `num_models` members of the stacked ensemble (None: all);
    the slices keep their device and dtype."""
    if num_models is None:
        return params
    return [[{k: v[:num_models] for k, v in layer.items()}
             for layer in layers] for layers in params]


def _mlp_stack(layers, x: torch.Tensor, celu_alpha: float,
               col_idx=None) -> torch.Tensor:
    """x: [m, n, aev] -> [m, n] atomic energies (one species net).

    `col_idx` (tuple): compact-AEV mode. x carries only these columns of
    the full AEV layout, so the first layer gathers the matching weight
    rows instead: absent species' columns never exist as data."""
    h = x
    for li, layer in enumerate(layers):
        w = layer["w"]
        if li == 0 and col_idx is not None:
            with sync("mlp_columns"):
                cols = torch.as_tensor(col_idx, device=w.device)
            w = w[:, cols, :]
        h = torch.baddbmm(layer["b"][:, None, :], h, w)
        if li < len(layers) - 1:
            h = _CELU.apply(h, celu_alpha)
    return h[..., 0]


def atomic_energies_masked(spec: NetworkSpec, params, species: torch.Tensor,
                           aev: torch.Tensor, present=None,
                           col_idx=None) -> torch.Tensor:
    """[m, n]: every species net on all atoms, masked combine. `present`
    (tuple): the species whose nets run (the system's composition; None:
    all); `col_idx` as in `_mlp_stack` (aev in compact columns)."""
    m = params[0][0]["w"].shape[0]
    n = aev.shape[0]
    x = aev[None].expand(m, n, aev.shape[1])
    out = aev.new_zeros((m, n))
    for s in (range(spec.num_species) if present is None else present):
        e_s = _mlp_stack(params[s], x, spec.celu_alpha, col_idx)
        out = torch.where((species == s)[None, :], e_s, out)
    return torch.where((species >= 0)[None, :], out, 0.0)


def atomic_energies_sorted(spec: NetworkSpec, params,
                           species_counts: Sequence[int],
                           aev_sorted: torch.Tensor,
                           col_idx=None) -> torch.Tensor:
    """[m, n] for species-sorted rows with static per-species counts
    (species 0 block, species 1 block, ..., then zero-energy padding);
    `col_idx` as in `_mlp_stack`."""
    m = params[0][0]["w"].shape[0]
    n = aev_sorted.shape[0]
    pieces = []
    offset = 0
    for s, count in enumerate(species_counts):
        if count == 0:
            continue
        x = aev_sorted[offset:offset + count]
        x = x[None].expand(m, count, x.shape[1])
        pieces.append(_mlp_stack(params[s], x, spec.celu_alpha, col_idx))
        offset += count
    out = (torch.cat(pieces, dim=1) if pieces
           else aev_sorted.new_zeros((m, 0)))
    if offset < n:
        out = torch.nn.functional.pad(out, (0, n - offset))
    return out


def ensemble_energies(atomic: torch.Tensor) -> torch.Tensor:
    """Mean over the model axis: [m, n] -> [n]."""
    return atomic.mean(dim=0)


@dataclasses.dataclass(frozen=True)
class EnergyShifter:
    """Per-species self-energy offsets in Hartree."""

    self_energies: tuple[float, ...]

    def __call__(self, species: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
        """[n] per-atom shift; 0 for padding (species -1)."""
        with sync("self_energies"):
            sae = torch.as_tensor(self.self_energies, dtype=dtype,
                                  device=species.device)
        safe = torch.clamp(species, 0, len(self.self_energies) - 1).long()
        return torch.where(species >= 0, sae[safe], 0.0)


# Published ANI-2x self atomic energies (Hartree, wB97X/6-31G*).
ANI2X_SELF_ENERGIES = (
    -0.5978583943827134,   # H
    -38.08933878049795,    # C
    -54.711968298621066,   # N
    -75.19106774742086,    # O
    -398.1577125334925,    # S
    -99.80348506781634,    # F
    -460.1681939421027,    # Cl
)

# ANI-1x self atomic energies (Hartree; HCNO).
ANI1X_SELF_ENERGIES = (
    -0.600952980000,  # H
    -38.08316124000,  # C
    -54.58049914300,  # N
    -75.01173938500,  # O
)
