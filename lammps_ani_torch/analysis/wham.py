"""WHAM: weighted-histogram analysis of umbrella-sampling windows.

Port of lammps_ani_tpu/analysis/wham.py (numpy only): the post-analysis
the reference leaves to per-window MBAR and plot scripts. It takes the CV
samples of `md.bias.run_windows` and returns a PMF over the (optionally
periodic) CV.
"""

from __future__ import annotations

import numpy as np

BOLTZ = 0.0019872067  # kcal/mol/K (LAMMPS real units)


def _delta(x, c, periodic):
    d = x - c
    if periodic:
        d = d - periodic * np.round(d / periodic)
    return d


def wham(
    samples,  # list over windows of 1-D CV sample arrays
    centers,  # [n_windows] bias centers
    k: float,  # harmonic bias constant, kcal/mol/rad^2 (E = 0.5 k d^2)
    temp: float = 300.0,
    n_bins: int = 72,
    periodic: float | None = None,  # CV period (e.g. 2 pi), None = open
    tol: float = 1e-10,
    max_iter: int = 50000,
):
    """Binned WHAM. Returns (bin_centers, pmf [kcal/mol], f_i).

    Self-consistent iteration: P(x) = sum_i H_i(x) / sum_i N_i
    exp((f_i - U_i(x)) / kT), f_i = -kT ln sum_x P(x) exp(-U_i(x) / kT)."""
    kt = BOLTZ * temp
    centers = np.asarray(centers, np.float64)
    if periodic:
        lo, hi = -periodic / 2.0, periodic / 2.0
    else:
        lo = min(float(np.min(s)) for s in samples)
        hi = max(float(np.max(s)) for s in samples)
        pad = 0.02 * (hi - lo)
        lo, hi = lo - pad, hi + pad
    edges = np.linspace(lo, hi, n_bins + 1)
    x = 0.5 * (edges[:-1] + edges[1:])

    n_i = np.array([len(s) for s in samples], np.float64)
    hist = np.zeros((len(samples), n_bins))
    for i, s in enumerate(samples):
        s = np.asarray(s, np.float64)
        if periodic:
            s = _delta(s, 0.0, periodic)
        hist[i] = np.histogram(s, bins=edges)[0]
    h_tot = hist.sum(axis=0)

    # bias energy of window i at bin x
    u = 0.5 * k * _delta(x[None, :], centers[:, None], periodic) ** 2
    bolt = np.exp(-u / kt)  # [n_windows, n_bins]

    f = np.zeros(len(samples))
    for _ in range(max_iter):
        denom = (n_i[:, None] * np.exp(f / kt)[:, None] * bolt).sum(axis=0)
        p = np.where(denom > 0, h_tot / np.maximum(denom, 1e-300), 0.0)
        z = (p[None, :] * bolt).sum(axis=1)
        f_new = -kt * np.log(np.maximum(z, 1e-300))
        f_new -= f_new[0]
        if np.max(np.abs(f_new - f)) < tol:
            f = f_new
            break
        f = f_new
    p = np.where(p > 0, p, np.nan)
    pmf = -kt * np.log(p / np.nansum(p))
    pmf -= np.nanmin(pmf)
    return x, pmf, f
