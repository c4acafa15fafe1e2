"""Collective-variable bias forces (umbrella sampling and restraints).

Port of lammps_ani_tpu/md/bias.py: a CV is a function of positions (in the
caller's atom order) and the box; `HarmonicBias` wraps it in a harmonic
window and gives its force through `Simulation(extra_force=...)`, the CV's
gradient from torch autograd on a detached copy of the positions (the step
itself runs without grad; the force returned is detached). `run_windows`
is the window fan-out.

CVs: distance, angle, dihedral (PLUMED's DISTANCE, ANGLE and TORSION).
Unlike the JAX package's, which take the plain difference pos[i] - pos[j]
whatever the box, the bond vectors here are minimum-image through inv(h)
when a box is given, as PLUMED's are: the engine wraps each atom on its
own at every rebuild, so a CV whose atoms straddle a periodic face would
otherwise jump by a box length. Where no atom straddles a face the two
agree to rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from ..ops.neighbors import cell_inverse, min_image


def _bond(pos, a, b, box):
    """pos[a] - pos[b], minimum image when `box` is given."""
    d = pos[a] - pos[b]
    if box is None:
        return d
    h = box.h.to(d.dtype)
    return min_image(d, h, cell_inverse(h))


def distance_cv(i: int, j: int):
    def cv(pos, box):
        return torch.linalg.norm(_bond(pos, i, j, box))
    return cv


def angle_cv(i: int, j: int, k: int):
    def cv(pos, box):
        a = _bond(pos, i, j, box)
        b = _bond(pos, k, j, box)
        cos = torch.dot(a, b) / (torch.linalg.norm(a) * torch.linalg.norm(b))
        return torch.arccos(torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7))
    return cv


def dihedral_cv(i: int, j: int, k: int, l: int):
    """Signed dihedral in radians (PLUMED TORSION convention)."""
    def cv(pos, box):
        b0 = _bond(pos, i, j, box)
        b1 = _bond(pos, k, j, box)
        b2 = _bond(pos, l, k, box)
        b1n = b1 / torch.linalg.norm(b1)
        v = b0 - torch.dot(b0, b1n) * b1n
        w = b2 - torch.dot(b2, b1n) * b1n
        return torch.atan2(torch.dot(torch.linalg.cross(b1n, v), w),
                           torch.dot(v, w))
    return cv


def _neg_grad(energy_fn, pos) -> torch.Tensor:
    """-dE/dpos at `pos`, detached, whether or not grad is enabled."""
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(energy_fn(p), p)
    return -g.detach()


@dataclasses.dataclass(frozen=True)
class HarmonicBias:
    """E = 0.5 k (cv - center)^2 [kcal/mol]; periodic CVs wrap the delta."""

    cv: Callable
    k: float
    center: float
    periodic: float | None = None  # period (e.g. 2 pi for dihedrals)

    def energy(self, pos, box):
        d = self.cv(pos, box) - self.center
        if self.periodic is not None:
            d = d - self.periodic * torch.round(d / self.periodic)
        return 0.5 * self.k * d * d

    def force(self, pos, box, step=None):
        """extra_force-compatible: [n, 3] bias force."""
        return _neg_grad(lambda p: self.energy(p, box), pos)


def combine(biases: Sequence[HarmonicBias]):
    """Many restraints -> one extra_force callable."""
    def force(pos, box, step=None):
        return _neg_grad(lambda p: sum(b.energy(p, box) for b in biases),
                         pos)
    return force


def run_windows(make_sim, pos0, box, centers, k, cv_factory,
                steps_per_window: int, sample_every: int = 10, seed: int = 0,
                periodic: float | None = None):
    """Umbrella fan-out: one window per center (submit_umbrella.py's
    counterpart). make_sim(extra_force) -> Simulation. Returns the CV
    samples of each window (caller-order positions, minimum image) for
    WHAM or MBAR."""
    samples = []
    for w, center in enumerate(centers):
        bias = HarmonicBias(cv=cv_factory(), k=k, center=float(center),
                            periodic=periodic)
        sim = make_sim(bias.force)
        state = sim.init_state(pos0, box, temp=getattr(
            sim.integrator, "temp", 300.0), seed=seed + w)
        cv = cv_factory()
        traj = []
        done = 0
        while done < steps_per_window:
            state, _ = sim.run(state, sample_every)
            done += sample_every
            pos = torch.as_tensor(sim.positions_input_order(state),
                                  dtype=state.pos.dtype,
                                  device=state.pos.device)
            traj.append(float(cv(pos, state.box)))
        samples.append(np.asarray(traj))
    return samples
