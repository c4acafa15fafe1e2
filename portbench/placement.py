"""Rigid molecules on a jittered, shuffled cubic lattice.

A frozen copy of the combustion example's placement (the program's
`examples/_placement.py` with `examples/combustion/prepare_system.py`):
one molecule per cell of a shuffled per_axis^3 lattice in a cube of the
stated density, each moved by a uniform jitter of +-`jitter` cells and
rotated at random, from `numpy.random.default_rng(seed)` in the same draw
order (the shuffle, then per molecule its jitter and its rotation), so the
same arrays bit for bit.
"""

from __future__ import annotations

import numpy as np

AVOGADRO = 6.02214076e23


def random_rotation(rng) -> np.ndarray:
    """[3, 3] rotation of a normalised quaternion of four normal draws."""
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def cube_edge(mass_g_mol: float, density_g_cm3: float) -> float:
    """The edge (A) of a cube of `mass_g_mol` at `density_g_cm3`."""
    vol_cm3 = mass_g_mol / AVOGADRO / density_g_cm3
    return (vol_cm3 * 1e24) ** (1.0 / 3.0)


def place(mols, edge: float, jitter: float, seed: int):
    """`mols`: a list of (symbols, [k, 3] positions) molecules. Returns
    (symbols [n], positions [n, 3]) in an `edge` cube from the origin."""
    rng = np.random.default_rng(seed)
    per_axis = int(np.ceil(len(mols) ** (1.0 / 3.0)))
    cells = [(i, j, k) for i in range(per_axis) for j in range(per_axis)
             for k in range(per_axis)]
    rng.shuffle(cells)
    cell = edge / per_axis
    symbols, pos = [], []
    for (sym, mpos), (i, j, k) in zip(mols, cells):
        center = (np.array([i, j, k]) + 0.5) * cell
        shift = rng.uniform(-jitter, jitter, 3) * cell
        r = random_rotation(rng)
        pos.append(mpos @ r.T + center + shift)
        symbols += list(sym)
    return symbols, np.concatenate(pos)
