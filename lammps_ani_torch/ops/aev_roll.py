"""Roll-grid AEV channels: four hand-written Hopper kernels and their plain
PyTorch versions.

Port of lammps_ani_tpu/ops/aev_pallas.py (renamed: nothing here is
Pallas). Both AEV channels are computed over the roll-bin grid of
ops/cell_roll.py: each binned center reads its neighbor candidates from
the surrounding bins — a shell-`s` window of (2s+1)^3 bins for the radial
channel (s = 2 on the shared fine grid), the 27-bin window for the angular
channel, which re-compacts its in-cutoff neighbors per species every step.
No neighbor matrix, no mirror tables.

Each kernel computes what its TPU kernel computes, at grid level:

  radial_fwd   [NC, cap, S*R] radial AEV of every grid slot
  radial_bwd   fcen [NC, cap, 3] center-role force, wing [NC, n_off*cap, 3]
               neighbor-role force per candidate lane, dh [3, 3] box
               cotangent (dE/dh = -sum S^T (gamma u))
  angular_fwd  [NC, cap, angular_length] and the worst per-species cap
               deficit (> 0: a cap truncated real neighbors this step)
  angular_bwd  fcen, wing [NC, 27*cap, 3], dh

Each wrapper below launches its CUDA kernel (csrc/aev_roll.cu, built at
first use by ops/_build.py) for tensors on the card, and runs the plain
PyTorch version beside it for tensors on the CPU. The plain versions keep
the TPU layout (materialized candidate planes, as `_candidates` builds
them); the kernels compute each candidate's bin, periodic wrap and shift
S @ h themselves. `_fold_wing` folds the wing slabs back to their owner
bins with `torch.roll` (glue, shared by both routes).

Conventions (as the TPU kernels): empty slots are parked at 1e6 with
species -1; self is excluded by lane index (lane == self_off*cap + slot);
pairs count at dist <= cutoff with dist = sqrt(max(d2, 1e-12)).

Grid caps: all four kernels take every cap up to 256 in both dtypes.
The radial kernels' blocks stage the window in passes of whole offsets.
The angular kernels keep a bin's whole 27-bin window in one block where
it fits (every cap the engines size), else stage it in passes of whole
offsets with the compaction carried per center (`angular_form` gives the
offsets a pass). Above 256, or at per-species caps whose per-warp slots
do not fit a block even in passes (angular_bwd's pair scalars grow as
A^2: one species alone takes cap 256 up to A = 188 in f32 and 131 in
f64), their wrappers and `Simulation`'s sizing raise ValueError
(`angular_cap_limit`, `check_cap`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..models.aev import _zeta_pow

# Plain-integer launch counts of the four CUDA kernels (one per wrapper
# call that launches its kernel) and call counts of their plain versions
# made by the wrappers (CPU tensors). `reset_counts()` zeroes both.
LAUNCHES = {"radial_fwd": 0, "radial_bwd": 0, "angular_fwd": 0,
            "angular_bwd": 0}
PLAIN_CALLS = dict.fromkeys(LAUNCHES, 0)

# The TPU kernels of ops/aev_pallas.py that the four kernels replace.
REPLACES = {
    "radial_fwd": "lammps_ani_tpu/ops/aev_pallas.py:260 _radial_fwd_kernel",
    "radial_bwd": "lammps_ani_tpu/ops/aev_pallas.py:299 _radial_bwd_kernel",
    "angular_fwd": "lammps_ani_tpu/ops/aev_pallas.py:737 _angular_fwd_kernel",
    "angular_bwd": "lammps_ani_tpu/ops/aev_pallas.py:777 _angular_bwd_kernel",
}

DEFICIT_FLOOR = -(2 ** 20)
PLAIN_CHUNK_ELEMS = 1 << 27


def reset_counts():
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


@functools.lru_cache(maxsize=None)
def _shell_offsets(shell: int) -> np.ndarray:
    """[(2s+1)^3, 3] neighbor-bin offsets, x outermost."""
    r = range(-shell, shell + 1)
    return np.array([(i, j, k) for i in r for j in r for k in r], np.int64)


# ---------------------------------------------------------------------------
# Static constants of the AEV spec
# ---------------------------------------------------------------------------


def radial_consts(spec):
    """(rc, eta, mu0, delta, n_shf) of the uniform radial grid."""
    shf = np.asarray(spec.shf_r, np.float64)
    if len(spec.eta_r) != 1:
        raise ValueError("roll radial kernels assume a single eta_r")
    delta = float(shf[1] - shf[0]) if len(shf) > 1 else 1.0
    if len(shf) > 1 and not np.allclose(np.diff(shf), delta, rtol=1e-6):
        raise ValueError("roll radial kernels assume a uniform shf_r grid")
    return (float(spec.radial_cutoff), float(spec.eta_r[0]), float(shf[0]),
            delta, len(shf))


def angular_consts(spec, dtype):
    """Scalars of the angular kernels (single eta_a and zeta)."""
    if len(spec.eta_a) != 1 or len(spec.zeta) != 1:
        raise ValueError("roll angular kernels assume single eta_a and zeta")
    shf_a = np.asarray(spec.shf_a, np.float64)
    delta = float(shf_a[1] - shf_a[0]) if len(shf_a) > 1 else 1.0
    if len(shf_a) > 1 and not np.allclose(np.diff(shf_a), delta, rtol=1e-6):
        raise ValueError("roll angular kernels assume a uniform shf_a grid")
    # f32 flushes e_j below exp(-75) to exact zero (no subnormals)
    tiny = -75.0 if dtype == torch.float32 else -700.0
    return dict(rca=float(spec.angular_cutoff), eta=float(spec.eta_a[0]),
                zeta=float(spec.zeta[0]), mu0=float(shf_a[0]), delta=delta,
                n_a=len(shf_a), tiny=tiny,
                cos_m=[float(np.cos(v)) for v in spec.shf_z],
                sin_m=[float(np.sin(v)) for v in spec.shf_z])


def _pair_blocks(spec, caps):
    """[(s1, s2, a1, a2, ch0, same)] in torchani triu order, caps > 0."""
    asub = spec.angular_sublength
    triu = spec.triu_index()
    return [(s1, s2, caps[s1], caps[s2], int(triu[s1, s2]) * asub, s1 == s2)
            for s1 in range(spec.num_species)
            for s2 in range(s1, spec.num_species)
            if caps[s1] and caps[s2]]


# ---------------------------------------------------------------------------
# Layout glue (shared by both routes)
# ---------------------------------------------------------------------------


def _to_grid_rows(inv, x, park):
    """[n, ...] -> [NC, cap, ...] via the inverse slot map (row gather)."""
    pad = x.new_full((1,) + tuple(x.shape[1:]), park)
    return torch.cat([x, pad], dim=0)[inv]


def _halo_pad(g4, shell, row_shift=None):
    """[nx,ny,nz,...] -> periodic halo of width `shell` on the three bin
    axes. `row_shift` [3, ...]: added to wrapped copies (-h[axis] on the
    low halo, +h[axis] on the high one)."""
    for axis in range(3):
        n = g4.shape[axis]
        lo = g4.narrow(axis, n - shell, shell)
        hi = g4.narrow(axis, 0, shell)
        if row_shift is not None:
            lo = lo - row_shift[axis]
            hi = hi + row_shift[axis]
        g4 = torch.cat([lo, g4, hi], dim=axis)
    return g4


def _candidates(ncells, pos_g, sp_g, h, shell):
    """Materialized candidate planes of every bin's window:
    (cand_pos [NC, n_off*cap, 3], cand_sp [NC, n_off*cap])."""
    nx, ny, nz = ncells
    nc, cap = sp_g.shape
    pos4 = pos_g.reshape(nx, ny, nz, cap, 3)
    sp4 = sp_g.reshape(nx, ny, nz, cap)
    pos_halo = _halo_pad(pos4, shell, row_shift=h[:, None, None, None, None, :])
    sp_halo = _halo_pad(sp4, shell)
    cps, css = [], []
    for ox, oy, oz in _shell_offsets(shell):
        sl = (slice(shell + ox, shell + ox + nx),
              slice(shell + oy, shell + oy + ny),
              slice(shell + oz, shell + oz + nz))
        cps.append(pos_halo[sl])
        css.append(sp_halo[sl])
    cp = torch.stack(cps, dim=3).reshape(nc, -1, 3)
    cs = torch.stack(css, dim=3).reshape(nc, -1)
    return cp, cs


def _wrap_shift_tables(ncells, shell, dtype, device):
    """[NC, n_off, 3] integer wrap shift S per (bin, offset): the candidate
    position equals its owner's + S @ h."""
    nx, ny, nz = ncells
    ax = [torch.arange(n, device=device) for n in (nx, ny, nz)]
    outs = []
    for off in _shell_offsets(shell):
        s = [(-(a + int(o) < 0).to(torch.int64)
              + (a + int(o) >= n).to(torch.int64))
             for a, o, n in zip(ax, off, (nx, ny, nz))]
        sx, sy, sz = torch.broadcast_tensors(s[0][:, None, None],
                                             s[1][None, :, None],
                                             s[2][None, None, :])
        outs.append(torch.stack([sx, sy, sz], dim=-1).reshape(-1, 3))
    return torch.stack(outs, dim=1).to(dtype)


def _fold_wing(ncells, shell, fcen, wing):
    """fcen [NC, cap, 3] + wing slabs rolled back to their owner bins:
    slab o of bin c belongs to bin c + off_o (mod ncells)."""
    nx, ny, nz = ncells
    nc, cap, _ = fcen.shape
    offsets = _shell_offsets(shell)
    w = wing.reshape(nx, ny, nz, len(offsets), cap, 3)
    dpos = fcen.reshape(nx, ny, nz, cap, 3)
    for o, (ox, oy, oz) in enumerate(offsets):
        dpos = dpos + torch.roll(w[:, :, :, o],
                                 shifts=(int(ox), int(oy), int(oz)),
                                 dims=(0, 1, 2))
    return dpos.reshape(nc, cap, 3)


def _row_chunks(nc, cap, w):
    """Row (bin) slices of the plain versions: each chunk's [rows, cap, W]
    geometry holds at most PLAIN_CHUNK_ELEMS elements, so the plain
    versions also run at the main path's grid size."""
    step = max(1, PLAIN_CHUNK_ELEMS // (cap * w))
    return [slice(i, min(i + step, nc)) for i in range(0, nc, step)]


def _window_geometry(pos_g, cp, cap, self_off, cutoff):
    """(d [NC,cap,W,3] = center - candidate, dist, in_cut) of a window."""
    d = pos_g[:, :, None, :] - cp[:, None, :, :]
    dist = torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=1e-12))
    w = cp.shape[1]
    lane = torch.arange(w, device=pos_g.device)
    sub = torch.arange(cap, device=pos_g.device)
    is_self = lane[None, :] == (self_off * cap + sub[:, None])
    in_cut = (dist <= cutoff) & ~is_self[None]
    return d, dist, in_cut


def _dh_from_lanes(ncells, shell, wing):
    """dh[m, c] = sum_lanes S_m * wing_c (= -sum S^T (gamma u))."""
    nc = wing.shape[0]
    sh = _wrap_shift_tables(ncells, shell, wing.dtype, wing.device)
    n_off = sh.shape[1]
    cap = wing.shape[1] // n_off
    s_lane = sh[:, :, None, :].expand(nc, n_off, cap, 3).reshape(nc, -1, 3)
    return torch.einsum("nwm,nwc->mc", s_lane, wing)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the four kernels (grid level)
# ---------------------------------------------------------------------------


def _species_onehot(cs, present, num_species, dtype):
    """[NC, W, S] one-hot of candidate species, absent species zeroed."""
    keep = torch.zeros(num_species + 1, dtype=torch.bool, device=cs.device)
    keep[list(present)] = True
    idx = torch.where(cs >= 0, cs.long(), num_species)
    oh = torch.nn.functional.one_hot(idx, num_species + 1).to(dtype)
    return (oh * keep.to(dtype))[..., :num_species]


def radial_fwd_plain(pos_g, sp_g, h, ncells, shell, spec, present):
    """[NC, cap, S*R] radial AEV of every grid slot."""
    rc, eta, mu0, delta, nr = radial_consts(spec)
    nc, cap = sp_g.shape
    n_off = len(_shell_offsets(shell))
    cp, cs = _candidates(ncells, pos_g, sp_g, h, shell)
    oh = _species_onehot(cs, present, spec.num_species, pos_g.dtype)
    outs = []
    for rs in _row_chunks(nc, cap, cp.shape[1]):
        _, dist, in_cut = _window_geometry(pos_g[rs], cp[rs], cap,
                                           (n_off - 1) // 2, rc)
        fc = torch.where(in_cut,
                         0.5 * torch.cos(dist * (math.pi / rc)) + 0.5, 0.0)
        x = torch.clamp(dist, max=rc + 1.0) - mu0  # parked slots stay finite
        cols = []
        for k in range(nr):
            xk = x - k * delta
            t = 0.25 * fc * torch.exp(-eta * xk * xk)  # [rows, cap, W]
            cols.append(torch.bmm(t, oh[rs]))  # [rows, cap, S]
        outs.append(torch.stack(cols, dim=-1).reshape(
            -1, cap, spec.num_species * nr))
    return torch.cat(outs)


def radial_bwd_plain(pos_g, sp_g, h, ncells, shell, spec, present, ga_g):
    """(fcen [NC,cap,3], wing [NC,n_off*cap,3], dh [3,3]) for the radial
    AEV cotangent ga_g [NC, cap, S*R]."""
    rc, eta, mu0, delta, nr = radial_consts(spec)
    nc, cap = sp_g.shape
    n_off = len(_shell_offsets(shell))
    cp, cs = _candidates(ncells, pos_g, sp_g, h, shell)
    oh_t = _species_onehot(cs, present, spec.num_species,
                           pos_g.dtype).transpose(1, 2)  # [NC, S, W]
    ga4 = ga_g.reshape(nc, cap, spec.num_species, nr)
    fcens, wings = [], []
    for rs in _row_chunks(nc, cap, cp.shape[1]):
        d, dist, in_cut = _window_geometry(pos_g[rs], cp[rs], cap,
                                           (n_off - 1) // 2, rc)
        fc = torch.where(in_cut,
                         0.5 * torch.cos(dist * (math.pi / rc)) + 0.5, 0.0)
        dfc = torch.where(
            in_cut, (-0.5 * math.pi / rc) * torch.sin(dist * (math.pi / rc)),
            0.0)
        x = torch.clamp(dist, max=rc + 1.0) - mu0
        gamma = torch.zeros_like(dist)
        for k in range(nr):
            xk = x - k * delta
            db = 0.25 * torch.exp(-eta * xk * xk) * (dfc
                                                     - (2.0 * eta) * xk * fc)
            gamma = gamma + db * torch.bmm(ga4[rs, ..., k].contiguous(),
                                           oh_t[rs])
        g = (gamma / dist)[..., None] * d  # [rows, cap, W, 3]
        fcens.append(g.sum(dim=2))
        wings.append(-g.sum(dim=1))
    wing = torch.cat(wings)
    return torch.cat(fcens), wing, _dh_from_lanes(ncells, shell, wing)


def _angular_slots(caps, present, pos_g, cp, cs, cst):
    """Per-step compaction of in-Rca window lanes into per-species slots,
    in ascending lane order (the first caps[s] in-cutoff lanes of species
    s), for the rows (bins) `pos_g` [rows, cap, 3] with their candidate
    planes `cp`, `cs`. Returns (slots {s: dict}, deficit, (d, dist, W))."""
    rca = cst["rca"]
    nc, cap = pos_g.shape[:2]
    d, dist, in_cut = _window_geometry(pos_g, cp, cap, 13, rca)
    w = cp.shape[1]
    # a dummy lane W (zero displacement) receives every empty slot
    d_pad = torch.nn.functional.pad(d, (0, 0, 0, 1))
    dist_pad = torch.nn.functional.pad(dist, (0, 1))
    big = 2.0 * rca + 10.0
    deficit = torch.full((), float(DEFICIT_FLOOR), dtype=pos_g.dtype,
                         device=pos_g.device)
    slots = {}
    lane_ids = torch.arange(w, device=pos_g.device).expand(nc, cap, w)
    for s in present:
        a_s = caps[s]
        m = in_cut & (cs[:, None, :] == s)
        count = m.sum(dim=-1)
        deficit = torch.maximum(deficit, (count.max() - a_s).to(deficit.dtype))
        rank = torch.cumsum(m.to(torch.int64), dim=-1) - 1
        idx = torch.where(m & (rank < a_s), rank, a_s)
        slot_lane = torch.full((nc, cap, a_s + 1), w, dtype=torch.int64,
                               device=pos_g.device)
        slot_lane = slot_lane.scatter(2, idx, lane_ids)[..., :a_s]
        cax = torch.gather(d_pad, 2, slot_lane[..., None].expand(-1, -1, -1, 3))
        cd = torch.gather(dist_pad, 2, slot_lane)
        cd = torch.where(slot_lane < w, cd, 0.0)
        mask = cd > 1e-6
        d_safe = torch.where(mask, cd, big)
        inside = mask & (cd <= rca)
        fc = torch.where(inside, 0.5 * torch.cos(cd * (math.pi / rca)) + 0.5,
                         0.0)
        dfc = torch.where(
            inside, (-0.5 * math.pi / rca) * torch.sin(cd * (math.pi / rca)),
            0.0)
        slots[s] = dict(u=cax / d_safe[..., None], d=d_safe, fc=fc, dfc=dfc,
                        mask=mask, lane=slot_lane)
    return slots, deficit, (d, dist, w)


def _pair_terms(cst, sl1, sl2, same):
    """Pair tensors [NC, cap, a1, a2] of one species-pair block."""
    pt = _pair_terms_core(
        cst, sl1["u"][:, :, :, None, :], sl2["u"][:, :, None, :, :],
        sl1["d"][:, :, :, None], sl2["d"][:, :, None, :],
        sl1["fc"][:, :, :, None], sl2["fc"][:, :, None, :])
    if same:
        a = pt["fc12"].shape[-1]
        eye = torch.eye(a, dtype=torch.bool, device=pt["fc12"].device)
        pt["fc12"] = torch.where(eye, 0.0, pt["fc12"])
    return pt


def _pair_terms_core(cst, u1, u2, d1, d2, fc1, fc2):
    """The pair-term body (aev_pallas.py `_pair_terms_core`) on broadcast
    arms: unit vectors u1, u2 (trailing axis 3), distances d1, d2 and
    cutoff values fc1, fc2."""
    cosq = torch.clamp(torch.sum(u1 * u2, dim=-1), -1.0, 1.0)
    c95 = 0.95 * cosq
    sv = torch.sqrt(1.0 - c95 * c95)
    fc12 = fc1 * fc2
    x2 = torch.clamp(0.5 * (d1 + d2), max=cst["rca"] + 1.0) - cst["mu0"]
    e_j = []
    for j in range(cst["n_a"]):
        a = -cst["eta"] * (x2 - j * cst["delta"]) ** 2
        e_j.append(torch.where(a > cst["tiny"], torch.exp(a), 0.0))
    base_m, f1_m = [], []
    for cm, sm in zip(cst["cos_m"], cst["sin_m"]):
        base = 0.5 * (1.0 + c95 * cm + sv * sm)
        base_m.append(base)
        f1_m.append(_zeta_pow(base, cst["zeta"]))
    return dict(u1=u1, u2=u2, d1=d1, d2=d2, fc1=fc1, fc2=fc2, c95=c95, sv=sv,
                fc12=fc12, x2=x2, e_j=e_j, base_m=base_m, f1_m=f1_m)


def angular_fwd_plain(pos_g, sp_g, h, ncells, spec, caps, present):
    """([NC, cap, angular_length], deficit) — `caps` are the effective
    per-species caps (0 for species not in `present`)."""
    cst = angular_consts(spec, pos_g.dtype)
    nc, cap = sp_g.shape
    nsz = len(cst["cos_m"])
    cp, cs = _candidates(ncells, pos_g, sp_g, h, 1)
    outs, deficits = [], []
    for rs in _row_chunks(nc, cap, cp.shape[1]):
        slots, deficit, _ = _angular_slots(caps, present, pos_g[rs], cp[rs],
                                           cs[rs], cst)
        deficits.append(deficit)
        out = pos_g.new_zeros((rs.stop - rs.start, cap, spec.angular_length))
        cols = {}
        for s1, s2, a1, a2, ch0, same in _pair_blocks(spec, caps):
            pt = _pair_terms(cst, slots[s1], slots[s2], same)
            scale = 1.0 if same else 2.0
            for j, e in enumerate(pt["e_j"]):
                f2 = pt["fc12"] * e
                for m, f1 in enumerate(pt["f1_m"]):
                    cols[ch0 + j * nsz + m] = scale * torch.sum(
                        f2 * f1, dim=(-2, -1))
        if cols:
            idx = torch.as_tensor(sorted(cols), device=pos_g.device)
            out = out.index_copy(2, idx, torch.stack(
                [cols[c] for c in sorted(cols)], dim=-1))
        outs.append(out)
    return torch.cat(outs), torch.stack(deficits).max()


def angular_bwd_plain(pos_g, sp_g, h, ncells, spec, caps, present, ga_g):
    """(fcen [NC,cap,3], wing [NC,27*cap,3], dh [3,3]) for the angular AEV
    cotangent ga_g [NC, cap, angular_length]."""
    cst = angular_consts(spec, pos_g.dtype)
    nc, cap = sp_g.shape
    cp, cs = _candidates(ncells, pos_g, sp_g, h, 1)
    fcens, wings = [], []
    for rs in _row_chunks(nc, cap, cp.shape[1]):
        fcen, wing = _angular_bwd_rows(spec, caps, present, cst, pos_g[rs],
                                       cp[rs], cs[rs], ga_g[rs])
        fcens.append(fcen)
        wings.append(wing)
    wing = torch.cat(wings)
    return torch.cat(fcens), wing, _dh_from_lanes(ncells, 1, wing)


def _angular_bwd_rows(spec, caps, present, cst, pos_g, cp, cs, ga_g):
    """(fcen, wing) of the rows `pos_g` [rows, cap, 3] (angular_bwd_plain)."""
    eta, zeta, delta = cst["eta"], cst["zeta"], cst["delta"]
    nsz = len(cst["cos_m"])
    nc, cap = pos_g.shape[:2]
    slots, _, (d, dist, w) = _angular_slots(caps, present, pos_g, cp, cs,
                                            cst)
    gacc = {s: dict(u=torch.zeros_like(sl["u"]), d=torch.zeros_like(sl["d"]),
                    fc=torch.zeros_like(sl["d"])) for s, sl in slots.items()}
    for s1, s2, a1, a2, ch0, same in _pair_blocks(spec, caps):
        pt = _pair_terms(cst, slots[s1], slots[s2], same)
        scale = 1.0 if same else 2.0
        df2 = [torch.zeros_like(pt["fc12"]) for _ in pt["e_j"]]
        dcos = torch.zeros_like(pt["fc12"])
        for m in range(nsz):
            f1 = pt["f1_m"][m]
            df1 = torch.zeros_like(pt["fc12"])
            for j, e in enumerate(pt["e_j"]):
                g_jm = (ga_g[:, :, ch0 + j * nsz + m] * scale)[..., None, None]
                df1 = df1 + g_jm * (pt["fc12"] * e)
                df2[j] = df2[j] + g_jm * f1
            dbase = df1 * (zeta / pt["base_m"][m]) * f1
            dcos = dcos + dbase * 0.5 * (
                cst["cos_m"][m] - pt["c95"] / pt["sv"] * cst["sin_m"][m]) * 0.95
        drmean = torch.zeros_like(dcos)
        dfc12 = torch.zeros_like(dcos)
        for j, e in enumerate(pt["e_j"]):
            drmean = drmean + df2[j] * pt["fc12"] * e * (-2.0 * eta) * (
                pt["x2"] - j * delta)
            dfc12 = dfc12 + df2[j] * e
        # rmean beyond rca + 1 is parked (clamped): no gradient
        drmean = torch.where(pt["d1"] + pt["d2"] <= 2.0 * (cst["rca"] + 1.0),
                             drmean, 0.0)
        if same:
            eye = torch.eye(a1, dtype=torch.bool, device=dcos.device)
            dfc12 = torch.where(eye, 0.0, dfc12)
        g1, g2 = gacc[s1], gacc[s2]
        g1["u"] = g1["u"] + torch.sum(dcos[..., None] * pt["u2"], dim=3)
        g1["d"] = g1["d"] + torch.sum(0.5 * drmean, dim=3)
        g1["fc"] = g1["fc"] + torch.sum(dfc12 * pt["fc2"], dim=3)
        g2["u"] = g2["u"] + torch.sum(dcos[..., None] * pt["u1"], dim=2)
        g2["d"] = g2["d"] + torch.sum(0.5 * drmean, dim=2)
        g2["fc"] = g2["fc"] + torch.sum(dfc12 * pt["fc1"], dim=2)
    # slot cotangents -> window lanes (transpose of the compaction)
    g_lane = d.new_zeros((nc, cap, w + 1, 4))
    for s, sl in slots.items():
        g = gacc[s]
        inv = 1.0 / sl["d"]
        gu_dot_u = torch.sum(g["u"] * sl["u"], dim=-1)
        g_ca = torch.where(sl["mask"][..., None], g["u"] * inv[..., None], 0.0)
        g_cd = torch.where(sl["mask"],
                           g["d"] + g["fc"] * sl["dfc"] - gu_dot_u * inv, 0.0)
        src = torch.cat([g_ca, g_cd[..., None]], dim=-1)
        g_lane = g_lane.scatter_add(
            2, sl["lane"][..., None].expand(-1, -1, -1, 4), src)
    g_lane = g_lane[:, :, :w]
    gt = g_lane[..., :3] + (g_lane[..., 3] / dist)[..., None] * d
    return gt.sum(dim=2), -gt.sum(dim=1)


# ---------------------------------------------------------------------------
# Kernel wrappers: the CUDA kernel for tensors on the card, the plain
# version for tensors on the CPU, an error for anything else
# ---------------------------------------------------------------------------


def _route(name, *tensors) -> bool:
    """True: launch the kernel. False: run the plain version (CPU)."""
    devs = {t.device.type for t in tensors}
    if devs == {"cuda"}:
        return True
    if devs == {"cpu"}:
        PLAIN_CALLS[name] += 1
        return False
    raise ValueError(f"{name}: tensors on devices {sorted(devs)}; expected "
                     "all on cuda or all on cpu")


def _launch(name, dtype, iparams, fparams, *tensors):
    """Call the C entry point `<name>_<f32|f64>` on the current stream."""
    from . import _build

    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous tensor {tuple(t.shape)}")
    fn = _build.entry(f"{name}_{_suffix(dtype, name)}", len(tensors) + 3)
    ip = np.ascontiguousarray(iparams, np.int32)
    fp = np.ascontiguousarray(fparams, np.float64)
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    err = fn(ip.ctypes.data, fp.ctypes.data,
             *[t.data_ptr() for t in tensors], stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed: "
                           f"{_build.error_string(err)} ({err})")
    LAUNCHES[name] += 1


def _suffix(dtype, name="roll kernels"):
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"{name}: dtype {dtype} not supported")


def _grid_iparams(ncells, cap):
    return [ncells[0], ncells[1], ncells[2], cap]


def _check_grid(name, ncells, pos_g, sp_g, h, ga_g=None, width=None):
    """The kernels trust these shapes and dtypes: check them first."""
    nc = ncells[0] * ncells[1] * ncells[2]
    cap = sp_g.shape[-1]
    ok = (sp_g.shape == (nc, cap) and sp_g.dtype == torch.int32
          and pos_g.shape == (nc, cap, 3) and h.shape == (3, 3)
          and h.dtype == pos_g.dtype
          and (ga_g is None or (ga_g.shape == (nc, cap, width)
                                and ga_g.dtype == pos_g.dtype)))
    if not ok:
        raise ValueError(
            f"{name}: grid inputs do not fit ncells {tuple(ncells)}: pos_g "
            f"{tuple(pos_g.shape)} {pos_g.dtype}, sp_g {tuple(sp_g.shape)} "
            f"{sp_g.dtype}, h {tuple(h.shape)} {h.dtype}"
            + ("" if ga_g is None else
               f", ga {tuple(ga_g.shape)} {ga_g.dtype} (width {width})"))


def radial_fwd(pos_g, sp_g, h, ncells, shell, spec, present):
    """[NC, cap, S*R] radial AEV (replaces aev_pallas._radial_fwd_kernel)."""
    if not _route("radial_fwd", pos_g, sp_g, h):
        return radial_fwd_plain(pos_g, sp_g, h, ncells, shell, spec, present)
    _check_grid("radial_fwd", ncells, pos_g, sp_g, h)
    nc, cap = sp_g.shape
    out = pos_g.new_empty((nc, cap, spec.radial_length))  # all written
    return _radial_fwd_into(out, pos_g, sp_g, h, ncells, shell, spec, present)


def _radial_fwd_into(out, pos_g, sp_g, h, ncells, shell, spec, present):
    """Launches the radial forward kernel into `out` [NC, cap, S*R], every
    entry of which it writes, and returns `out`."""
    rc, eta, mu0, delta, nr = radial_consts(spec)
    nc, cap = sp_g.shape
    if (out.shape != (nc, cap, spec.num_species * nr)
            or out.dtype != pos_g.dtype or not out.is_contiguous()):
        raise ValueError(f"radial_fwd: out {tuple(out.shape)} {out.dtype}")
    mask = sum(1 << s for s in present)
    _launch("radial_fwd", pos_g.dtype,
            _grid_iparams(ncells, cap) + [shell, spec.num_species, nr, mask],
            [rc, eta, mu0, delta], pos_g, sp_g, h, out)
    return out


def radial_bwd(pos_g, sp_g, h, ncells, shell, spec, present, ga_g):
    """(fcen, wing, dh) (replaces aev_pallas._radial_bwd_kernel)."""
    if not _route("radial_bwd", pos_g, sp_g, h, ga_g):
        return radial_bwd_plain(pos_g, sp_g, h, ncells, shell, spec, present,
                                ga_g)
    _check_grid("radial_bwd", ncells, pos_g, sp_g, h, ga_g,
                spec.radial_length)
    rc, eta, mu0, delta, nr = radial_consts(spec)
    nc, cap = sp_g.shape
    n_off = len(_shell_offsets(shell))
    fcen = pos_g.new_empty((nc, cap, 3))
    wing = pos_g.new_empty((nc, n_off * cap, 3))
    dh_part = pos_g.new_empty((nc, 9))
    dh = pos_g.new_empty((3, 3))
    mask = sum(1 << s for s in present)
    _launch("radial_bwd", pos_g.dtype,
            _grid_iparams(ncells, cap) + [shell, spec.num_species, nr, mask],
            [rc, eta, mu0, delta], pos_g, sp_g, h, ga_g, fcen, wing, dh_part,
            dh)
    return fcen, wing, dh


# The dynamic shared memory a block of the roll kernels may take (227 KB
# less 2 KB for their static arrays), and the angular hosts' largest cap
# (the radial kernels' too).
MAX_DYN_SMEM = 227 * 1024 - 2048
MAX_ANG_CAP = 256
# The most warps a block of angular_fwd or angular_bwd holds.
ANG_MAX_WARPS = 8


def _al16(nbytes):
    return (nbytes + 15) & ~15


def _max_block_pairs(caps):
    """The largest species-pair block's slot pairs (at least 1)."""
    q = [c * (c - 1) // 2 for c in caps]
    q += [c1 * c2 for i, c1 in enumerate(caps) for c2 in caps[i + 1:]]
    return max([1] + q)


def _ang_sizes(name, caps, dtype):
    """(staged-lane bytes, A, bytes of a warp's scratch in the whole-window
    kernel: angular_fwd its slots [5][A], angular_bwd 11 A + 3 Q + 32
    values and A ints, Q the largest block's slot pairs)."""
    if name not in ("angular_fwd", "angular_bwd"):
        raise ValueError(f"{name}: no cap limit")
    t = torch.empty((), dtype=dtype).element_size()
    a = sum(caps)
    if name == "angular_fwd":
        return 4 * t, a, t * 5 * a
    return 4 * t, a, _al16(t * (11 * a + 3 * _max_block_pairs(caps) + 32)
                           + 4 * a)


def angular_smem(name, cap, caps, dtype):
    """Bytes of dynamic shared memory a one-warp block of the whole-window
    angular kernel `name` takes at grid cap `cap` (csrc/aev_roll.cu
    `af_smem`, `bwd_smem`): the 27-bin window of staged lanes (16 bytes a
    lane in f32, 32 in f64) and a warp's scratch; angular_bwd also the
    centers' slot results [cap][A] (a staged lane each) and their species
    int [cap]; A = sum(caps)."""
    lane, a, warp = _ang_sizes(name, caps, dtype)
    if name == "angular_fwd":
        return lane * 27 * cap + warp
    return lane * 27 * cap + lane * cap * a + _al16(4 * cap) + warp


def angular_pass_smem(name, cap, caps, dtype, opp, warps=1):
    """Bytes of dynamic shared memory a block of `warps` warps of the pass
    form of `name` takes staging `opp` window offsets a pass
    (`ang_pass_smem`): the pass's staged lanes [opp cap], the bin's real
    centers int [cap], and each warp's scratch: angular_fwd its slots
    [5][A] (to 16 bytes); angular_bwd the whole-window kernel's and its
    center's results [A] (a staged lane each)."""
    lane, a, warp = _ang_sizes(name, caps, dtype)
    if name == "angular_fwd":
        warp = _al16(warp)
    else:
        warp += lane * a
    return _al16(lane * opp * cap) + _al16(4 * cap) + warps * warp


def angular_form(name, cap, caps, dtype, device=None):
    """The window offsets a block of the angular kernel `name` stages a
    pass at grid cap `cap` and per-species caps `caps` (`ang_form`): 27,
    the whole window in one block, where its one-warp layout fits (every
    cap the engines size); else the pass form's x-plane (9), x-y row (3) or
    one offset, the first whose layout holds a block of the most warps,
    else one offset at fewer warps; 0 where the kernel does not take the
    cap. For a CUDA `device` the kernel's host code answers
    (`<name>_form_<f32|f64>`), otherwise this transcription."""
    caps = tuple(int(c) for c in caps)
    if device is not None and torch.device(device).type == "cuda":
        return _host_answer(f"{name}_form", dtype, caps, int(cap))
    if not 1 <= cap <= MAX_ANG_CAP:
        return 0
    if angular_smem(name, cap, caps, dtype) <= MAX_DYN_SMEM:
        return 27
    opp = 9
    while opp > 1 and angular_pass_smem(
            name, cap, caps, dtype, opp, ANG_MAX_WARPS) > MAX_DYN_SMEM:
        opp //= 3
    fits = angular_pass_smem(name, cap, caps, dtype, opp) <= MAX_DYN_SMEM
    return opp if fits else 0


def angular_cap_limit(name, dtype, caps, device=None):
    """The largest grid cap the angular kernel `name` takes at the
    per-species caps `caps`: MAX_ANG_CAP where one offset a pass and one
    warp fit a block (at the caps the engines size), else the most whose
    whole window fits, or 0. For a CUDA `device` the kernel's host
    code answers (`<name>_cap_limit_<f32|f64>`), otherwise `angular_form`,
    its transcription."""
    caps = tuple(int(c) for c in caps)
    if device is not None and torch.device(device).type == "cuda":
        return _host_answer(f"{name}_cap_limit", dtype, caps, 0)
    lo, hi = 0, MAX_ANG_CAP
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if angular_form(name, mid, caps, dtype) > 0:
            lo = mid
        else:
            hi = mid - 1
    return lo


@functools.lru_cache(maxsize=None)
def _host_answer(fn_name, dtype, caps, cap):
    from . import _build

    fn = _build.entry(f"{fn_name}_{_suffix(dtype)}", 2)
    ip = np.ascontiguousarray([0, 0, 0, cap, len(caps), 0] + list(caps),
                              np.int32)
    fp = np.zeros(6 + 16, np.float64)
    out = fn(ip.ctypes.data, fp.ctypes.data)
    if out < 0:
        raise ValueError(f"{fn_name}: caps {caps} not taken")
    return out


def check_cap(name, cap, caps, dtype, device=None):
    """Raises ValueError, naming the kernel, the cap, the dtype and the
    limit, where the angular kernel `name` does not take grid cap `cap`
    at the per-species caps `caps` (see `angular_cap_limit`)."""
    limit = angular_cap_limit(name, dtype, caps, device)
    if cap > limit:
        raise ValueError(
            f"{name}: grid cap {cap} above {limit}, the most its "
            f"{str(dtype).replace('torch.', '')} kernel takes at angular "
            f"caps {tuple(caps)} (at most {MAX_ANG_CAP}; less only where "
            "the caps' per-warp slots do not fit a block)")


def _angular_params(spec, caps, dtype):
    cst = angular_consts(spec, dtype)
    if cst["n_a"] != 4 or len(cst["cos_m"]) != 8:
        raise ValueError("angular kernels are built for 4 shf_a x 8 shf_z")
    zi = int(round(cst["zeta"]))
    zeta_int = zi if abs(cst["zeta"] - zi) <= 1e-9 and 1 <= zi <= 128 else 0
    fparams = ([cst["rca"], cst["eta"], cst["zeta"], cst["mu0"], cst["delta"],
                cst["tiny"]] + cst["cos_m"] + cst["sin_m"])
    return [spec.num_species, zeta_int] + list(caps), fparams


def angular_fwd(pos_g, sp_g, h, ncells, spec, caps, present,
                pass_form=False):
    """([NC, cap, angular_length], deficit) (replaces
    aev_pallas._angular_fwd_kernel). `pass_form`: launch the pass form
    even where the whole window fits (a check of its walk: the same
    bits)."""
    if not _route("angular_fwd", pos_g, sp_g, h):
        return angular_fwd_plain(pos_g, sp_g, h, ncells, spec, caps, present)
    _check_grid("angular_fwd", ncells, pos_g, sp_g, h)
    nc, cap = sp_g.shape
    check_cap("angular_fwd", cap, caps, pos_g.dtype, pos_g.device)
    out = pos_g.new_empty((nc, cap, spec.angular_length))  # all written
    deficit = torch.full((1,), DEFICIT_FLOOR, dtype=torch.int32,
                         device=pos_g.device)
    ip, fp = _angular_params(spec, caps, pos_g.dtype)
    _launch("angular_fwd", pos_g.dtype,
            _grid_iparams(ncells, cap) + ip + [int(pass_form)], fp, pos_g,
            sp_g, h, out, deficit)
    return out, deficit[0].to(pos_g.dtype)


def angular_bwd(pos_g, sp_g, h, ncells, spec, caps, present, ga_g,
                pass_form=False):
    """(fcen, wing, dh) (replaces aev_pallas._angular_bwd_kernel);
    `pass_form` as angular_fwd's."""
    if not _route("angular_bwd", pos_g, sp_g, h, ga_g):
        return angular_bwd_plain(pos_g, sp_g, h, ncells, spec, caps, present,
                                 ga_g)
    _check_grid("angular_bwd", ncells, pos_g, sp_g, h, ga_g,
                spec.angular_length)
    nc, cap = sp_g.shape
    check_cap("angular_bwd", cap, caps, pos_g.dtype, pos_g.device)
    fcen = pos_g.new_empty((nc, cap, 3))
    wing = pos_g.new_empty((nc, 27 * cap, 3))  # every lane is written
    dh_part = pos_g.new_empty((nc, 9))
    dh = pos_g.new_empty((3, 3))
    ip, fp = _angular_params(spec, caps, pos_g.dtype)
    _launch("angular_bwd", pos_g.dtype,
            _grid_iparams(ncells, cap) + ip + [int(pass_form)], fp, pos_g,
            sp_g, h, ga_g, fcen, wing, dh_part, dh)
    return fcen, wing, dh


# ---------------------------------------------------------------------------
# Flat-row implementations (the JAX package's *_impl functions)
# ---------------------------------------------------------------------------


def _grid_inputs(inv, pos, csp_grid):
    return (_to_grid_rows(inv, pos, 1e6).contiguous(),
            csp_grid.to(torch.int32).contiguous())


def _radial_fwd_impl(spec, grid, present, shell, pos, h, inv, csp_grid,
                     cell, slot):
    pos_g, sp_g = _grid_inputs(inv, pos, csp_grid)
    out = radial_fwd(pos_g, sp_g, h.contiguous(), grid.ncells, shell, spec,
                     present)
    return out[cell, slot]


def _radial_bwd_impl(spec, grid, present, shell, pos, h, inv, csp_grid,
                     cell, slot, ga_flat):
    pos_g, sp_g = _grid_inputs(inv, pos, csp_grid)
    ga_g = _to_grid_rows(inv, ga_flat, 0.0).contiguous()
    fcen, wing, dh = radial_bwd(pos_g, sp_g, h.contiguous(), grid.ncells,
                                shell, spec, present, ga_g)
    return _fold_wing(grid.ncells, shell, fcen, wing)[cell, slot], dh


def _angular_fwd_impl(spec, grid, caps, present, pos, h, inv, csp_grid,
                      cell, slot):
    pos_g, sp_g = _grid_inputs(inv, pos, csp_grid)
    out, deficit = angular_fwd(pos_g, sp_g, h.contiguous(), grid.ncells,
                               spec, caps, present)
    return out[cell, slot], deficit


def _angular_bwd_impl(spec, grid, caps, present, pos, h, inv, csp_grid,
                      cell, slot, ga_flat):
    pos_g, sp_g = _grid_inputs(inv, pos, csp_grid)
    ga_g = _to_grid_rows(inv, ga_flat, 0.0).contiguous()
    fcen, wing, dh = angular_bwd(pos_g, sp_g, h.contiguous(), grid.ncells,
                                 spec, caps, present, ga_g)
    return _fold_wing(grid.ncells, 1, fcen, wing)[cell, slot], dh


class _RadialRoll(torch.autograd.Function):
    """[n, S*R] radial AEV; backward = the radial backward kernel (exact
    dpos and box cotangent)."""

    @staticmethod
    def forward(ctx, pos, h, inv, csp_grid, cell, slot, static):
        ctx.static = static
        ctx.save_for_backward(pos, h, inv, csp_grid, cell, slot)
        return _radial_fwd_impl(*static, pos, h, inv, csp_grid, cell, slot)

    @staticmethod
    def backward(ctx, ga):
        dpos, dh = _radial_bwd_impl(*ctx.static, *ctx.saved_tensors,
                                    ga.contiguous())
        return dpos, dh, None, None, None, None, None


class _AngularRoll(torch.autograd.Function):
    """([n, angular_length], deficit); the deficit carries no gradient."""

    @staticmethod
    def forward(ctx, pos, h, inv, csp_grid, cell, slot, static):
        ctx.static = static
        ctx.save_for_backward(pos, h, inv, csp_grid, cell, slot)
        out, deficit = _angular_fwd_impl(*static, pos, h, inv, csp_grid,
                                         cell, slot)
        ctx.mark_non_differentiable(deficit)
        return out, deficit

    @staticmethod
    def backward(ctx, ga, _):
        dpos, dh = _angular_bwd_impl(*ctx.static, *ctx.saved_tensors,
                                     ga.contiguous())
        return dpos, dh, None, None, None, None, None


def present_species(spec, species_counts=None):
    if species_counts is not None:
        return tuple(s for s, c in enumerate(species_counts) if c > 0)
    return tuple(range(spec.num_species))


def effective_caps(spec, caps, species_counts=None):
    """(caps with absent species zeroed, present species with caps > 0)."""
    present = tuple(s for s in present_species(spec, species_counts)
                    if caps[s] > 0)
    return tuple(c if s in present else 0 for s, c in enumerate(caps)), present


def radial_aev_roll(aev_spec, grid, bins, pos, box, species_counts=None,
                    shell=1):
    """[n, S*R] radial AEV over the roll grid; differentiable w.r.t. `pos`
    and `box.h`. `shell=2` serves bins half the cutoff wide."""
    static = (aev_spec, grid, present_species(aev_spec, species_counts), shell)
    return _RadialRoll.apply(pos, box.h, bins.inv, bins.species_grid,
                             bins.cell, bins.slot, static)


def angular_aev_roll(aev_spec, grid, bins, pos, box, caps,
                     species_counts=None):
    """([n, angular_length], deficit) over the roll grid's 27-bin window.
    `caps`: per-species angular-neighbor capacities; deficit > 0 means a
    cap truncated real neighbors this evaluation."""
    caps_eff, present = effective_caps(aev_spec, caps, species_counts)
    static = (aev_spec, grid, caps_eff, present)
    return _AngularRoll.apply(pos, box.h, bins.inv, bins.species_grid,
                              bins.cell, bins.slot, static)
