"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Asking
for the card on a machine without one raises: the port never carries on
silently on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card; anything else is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lammps_ani_torch: a CUDA device was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path")
    return dev
