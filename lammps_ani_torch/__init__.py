"""lammps_ani_torch — the PyTorch/CUDA port of lammps_ani_tpu.

A second package beside the JAX one: ANI potentials and the MD engine in
PyTorch, with the AEV kernels written by hand in CUDA C++ for Hopper
(`csrc/`). It imports neither JAX nor `lammps_ani_tpu`; the tests hold it
against the JAX package on the same inputs.

Precision policy (mirrors lammps_ani_tpu/__init__.py): float32 matrix
products run in full float32 — no TF32 anywhere — so f32 geometry and MLP
products keep their digits.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .ops.neighbors import Box, Ghosts, NeighborList  # noqa: E402
from .models.aev import AEVSpec, ani1x_aev_spec, ani2x_aev_spec, compute_aev  # noqa: E402
from .models.networks import EnergyShifter, NetworkSpec  # noqa: E402
from .models.potential import (  # noqa: E402
    ANIPotential,
    ANISpec,
    atomic_energies,
    atomic_energies_asn,
    atomic_energies_mirror,
    atomic_energies_roll,
    energy_forces,
    energy_forces_virial,
    energy_forces_virial_asn,
    energy_forces_virial_mirror,
    energy_forces_virial_roll,
    potential_energy,
)
from .models.repulsion import RepulsionSpec  # noqa: E402
from .md.simulation import NeighborConfig, Simulation  # noqa: E402
from .md.state import MDState  # noqa: E402
from .md import integrate  # noqa: E402
from . import units  # noqa: E402

__version__ = "0.1.0"
