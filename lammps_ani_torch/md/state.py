"""Simulation state.

Port of lammps_ani_tpu/md/state.py: everything that evolves during a run
(LAMMPS `real` units), held as tensors on the run's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.neighbors import Box


@dataclasses.dataclass(frozen=True)
class MDState:
    pos: torch.Tensor  # [n, 3] Angstrom
    vel: torch.Tensor  # [n, 3] Angstrom/fs
    force: torch.Tensor  # [n, 3] kcal/mol/Angstrom
    box: Box
    step: int
    pe: torch.Tensor  # [] kcal/mol at `pos`
    virial: torch.Tensor  # [3, 3] kcal/mol
    pos_at_rebuild: torch.Tensor  # [n, 3] for the half-skin check
    bins: Optional[object] = None  # ops/cell_roll.RollBins of the rebuild
    # mirror engine and hybrids: the rebuild's neighbor matrix
    # (ops/neighbors.NeighborList) and its owner/shift/mirror form
    # (ops/nbr_grad.MirrorNeighbors)
    nlist: Optional[object] = None
    nbrs: Optional[object] = None

    def replace(self, **kw) -> "MDState":
        return dataclasses.replace(self, **kw)
