"""The plain reference of an ANI potential with the XTB core repulsion.

Plain PyTorch, written from the published functional form (Smith et al.,
Chem. Sci. 8, 3192 (2017); torchani's AEV layout) and from a
configuration file of `portbench/configs/`; it imports nothing of the
program under test. Energies in kcal/mol, forces in kcal/mol/A, the
virial as LAMMPS takes it (kcal/mol; W = -sym(dE/d strain)).

  cutoff   fc(r; Rc) = 0.5 cos(pi r / Rc) + 0.5 for r <= Rc, else 0
  radial   G_R = 0.25 exp(-eta_r (r - shf_r)^2) fc(r; Rcr)
  angular  G_A = 2 ((1 + cos(theta - shf_z)) / 2)^zeta
                 exp(-eta_a ((r_ij + r_ik) / 2 - shf_a)^2) fc(r_ij) fc(r_ik)
           with cos(theta) = 0.95 d_ij.d_ik / (r_ij r_ik)
  network  per species: Linear, CELU(0.1), ..., Linear to one output;
           the mean over the ensemble, plus the species' self energy
  XTB      per pair, half to each atom: Zeff_i Zeff_j / r exp(-sqrt(alpha_i
           alpha_j) r^k_f) (bohr, Hartree) times exp(1 - 1 / (1 - x^2)),
           x = r / rc, below the cutoff

The energy is a function of the directed pair vectors d_ij = x_j - x_i
(minimum image) of one pair list; its gradient g_ij gives the forces
(F_i += g_ij, F_j -= g_ij) and the virial (-sym(sum d_ij g_ij^T)). The
centers are taken in blocks so that the triples of a block fit on the
card.
"""

from __future__ import annotations

import math

import torch

HARTREE2KCALMOL = 627.5094738898777
ANGSTROM2BOHR = 1.8897261258369282


class Model:
    """A configuration's constants and one set of ensemble weights
    (species -> layers -> {"w": [m, d_in, d_out], "b": [m, d_out]}) in
    `dtype` on `device`."""

    def __init__(self, cfg: dict, params, dtype=torch.float64,
                 device="cpu"):
        a = cfg["aev"]
        t = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.dtype, self.device = dtype, torch.device(device)
        self.rcr, self.rca = float(a["radial_cutoff"]), float(
            a["angular_cutoff"])
        self.eta_r = torch.tensor(a["eta_r"], **t)
        self.shf_r = torch.tensor(a["shf_r"], **t)
        self.eta_a = torch.tensor(a["eta_a"], **t)
        self.zeta = [float(z) for z in a["zeta"]]
        self.shf_a = torch.tensor(a["shf_a"], **t)
        self.cz = torch.cos(torch.tensor(a["shf_z"], dtype=torch.float64)
                            ).to(**t)
        self.sz = torch.sin(torch.tensor(a["shf_z"], dtype=torch.float64)
                            ).to(**t)
        self.ns = len(cfg["symbols"])
        self.n_rad = len(a["eta_r"]) * len(a["shf_r"])
        self.n_ang = (len(a["eta_a"]) * len(a["zeta"]) * len(a["shf_a"])
                      * len(a["shf_z"]))
        self.aev_len = (self.ns * self.n_rad
                        + self.ns * (self.ns + 1) // 2 * self.n_ang)
        tri = torch.zeros((self.ns, self.ns), dtype=torch.int64)
        k = 0
        for i in range(self.ns):
            for j in range(i, self.ns):
                tri[i, j] = tri[j, i] = k
                k += 1
        self.tri = tri.to(device)
        self.celu = float(cfg["celu_alpha"])
        self.sae = torch.tensor(cfg["self_energies"], **t)
        rep = cfg["repulsion"]
        self.rep_cut = float(rep["cutoff"])
        self.rep_alpha = torch.tensor(rep["alpha"], **t)
        self.rep_zeff = torch.tensor(rep["zeff"], **t)
        self.k_f = float(rep["k_f"])
        if rep["cutoff_fn"] != "smooth":
            raise ValueError("the reference carries the smooth envelope only")
        self.params = [[{k: v.to(**t) for k, v in layer.items()}
                        for layer in layers] for layers in params]
        self.cutoff = max(self.rcr, self.rep_cut)

    # ---- the terms ----

    def _fc(self, r, rc):
        return torch.where(r <= rc, 0.5 * torch.cos(r * (math.pi / rc)) + 0.5,
                           0.0)

    def radial(self, r):
        """[P, n_rad] for distances [P] (eta_r-major)."""
        g = 0.25 * torch.exp(-self.eta_r[:, None]
                             * (r[:, None, None] - self.shf_r) ** 2)
        return (g * self._fc(r, self.rcr)[:, None, None]).reshape(
            len(r), self.n_rad)

    def angular(self, d1, d2, r1, r2):
        """[T, n_ang] for the triples' two arms, in torchani's order
        (eta_a, zeta, shf_a, shf_z)."""
        cos = (d1 * d2).sum(-1) / (r1 * r2)
        c = 0.95 * torch.clamp(cos, -1.0, 1.0)
        s = torch.sqrt(1.0 - c * c)
        base = 0.5 * (1.0 + c[:, None] * self.cz + s[:, None] * self.sz)
        f1 = torch.stack([base ** z for z in self.zeta], 1)  # [T, Z, S]
        rmean = 0.5 * (r1 + r2)
        f2 = torch.exp(-self.eta_a[:, None]
                       * (rmean[:, None, None] - self.shf_a) ** 2)  # [T,E,A]
        f2 = f2 * (self._fc(r1, self.rca) * self._fc(r2, self.rca)
                   )[:, None, None]
        out = 2.0 * f2[:, :, None, :, None] * f1[:, None, :, None, :]
        return out.reshape(len(r1), self.n_ang)

    def repulsion(self, si, sj, r):
        """[P] pair energies (Hartree) of directed pairs, halved."""
        rb = r * ANGSTROM2BOHR
        a = torch.sqrt(self.rep_alpha[si] * self.rep_alpha[sj])
        z = self.rep_zeff[si] * self.rep_zeff[sj]
        x2 = torch.clamp((r / self.rep_cut) ** 2, 0.0, 1.0 - 1e-6)
        env = torch.exp(1.0 - 1.0 / (1.0 - x2))
        e = z / rb * torch.exp(-a * rb ** self.k_f) * env
        return torch.where(r < self.rep_cut, 0.5 * e, 0.0)

    def network(self, species, aev):
        """[B] ensemble-mean atomic energies (Hartree) plus self energies."""
        out = aev.new_zeros(aev.shape[0])
        for s in range(self.ns):
            rows = torch.nonzero(species == s).flatten()
            if len(rows) == 0:
                continue
            h = aev[rows][None].expand(self.params[s][0]["w"].shape[0], -1,
                                       -1)
            layers = self.params[s]
            for li, layer in enumerate(layers):
                h = torch.baddbmm(layer["b"][:, None, :], h, layer["w"])
                if li < len(layers) - 1:
                    h = celu(h, self.celu)
            out = out.index_add(0, rows, h[..., 0].mean(0))
        return out + self.sae[species]


def celu(x, alpha):
    """max(x, 0) + alpha expm1(min(x, 0) / alpha), differentiated by
    autograd from the input (PyTorch's celu backward works from the
    output and keeps about 7 digits of it for negative inputs)."""
    return torch.where(x > 0, x, alpha * torch.expm1(
        torch.clamp(x, max=0.0) / alpha))


# ---------------------------------------------------------------------------
# Pairs
# ---------------------------------------------------------------------------


def min_image(d, lengths):
    return d - lengths * torch.round(d / lengths)


def candidate_blocks(pos, lengths, cutoff, block=8192):
    """Blocks of candidate neighbors under the minimum image of an
    orthorhombic box of side `lengths` [3] (each side more than twice the
    cutoff): (s, e, j [e - s, C], mask [e - s, C]) with mask true where j
    lies within `cutoff` of atom s + row, j != s + row. A cell list of at
    least 3 cells a side where the box allows it, every atom otherwise."""
    n = pos.shape[0]
    dev = pos.device
    if bool((lengths <= 2.0 * cutoff).any()):
        raise ValueError("the box must be more than twice the cutoff a side")
    ncell = torch.floor(lengths / cutoff).to(torch.int64).clamp(min=1)
    if bool((ncell < 3).any()) or n <= 2048:
        for s in range(0, n, block):
            e = min(n, s + block)
            d = min_image(pos[None, :, :] - pos[s:e, None, :], lengths)
            mask = (d * d).sum(-1) < cutoff * cutoff
            mask[torch.arange(e - s, device=dev),
                 torch.arange(s, e, device=dev)] = False
            yield s, e, torch.arange(n, device=dev).expand(e - s, n), mask
        return
    frac = torch.remainder(pos / lengths, 1.0)
    c3 = torch.minimum((frac * ncell).to(torch.int64), ncell - 1)
    cid = (c3[:, 0] * ncell[1] + c3[:, 1]) * ncell[2] + c3[:, 2]
    nc = int(ncell.prod())
    order = torch.argsort(cid, stable=True)
    counts = torch.bincount(cid, minlength=nc)
    cap = int(counts.max())
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - start[cid[order]]
    table = torch.full((nc, cap), -1, dtype=torch.int64, device=dev)
    table[cid[order], rank] = order
    offs = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                         for c in (-1, 0, 1)], device=dev)
    for s in range(0, n, block):
        e = min(n, s + block)
        nb = torch.remainder(c3[s:e, None, :] + offs[None], ncell)
        nid = (nb[..., 0] * ncell[1] + nb[..., 1]) * ncell[2] + nb[..., 2]
        cand = table[nid].reshape(e - s, 27 * cap)
        valid = cand >= 0
        cj = torch.where(valid, cand, 0)
        d = min_image(pos[cj] - pos[s:e, None, :], lengths)
        ii = torch.arange(s, e, device=dev)[:, None]
        yield s, e, cj, (valid & ((d * d).sum(-1) < cutoff * cutoff)
                         & (cj != ii))


def pair_list(pos, lengths, cutoff):
    """Directed pairs (i, j), i != j, within `cutoff` (minimum image),
    sorted by i: (i [P], j [P])."""
    out_i, out_j = [], []
    for s, _, cj, mask in candidate_blocks(pos, lengths, cutoff):
        rows, cols = torch.nonzero(mask, as_tuple=True)
        out_i.append(rows + s)
        out_j.append(cj[rows, cols])
    return torch.cat(out_i), torch.cat(out_j)


def _triples(center_local, n_centers):
    """For arm lists sorted by center (center_local [A], 0..n_centers-1):
    every unordered pair of arms of one center, as indices into the arm
    list (a [T], b [T])."""
    dev = center_local.device
    cnt = torch.bincount(center_local, minlength=n_centers)
    t = cnt * (cnt - 1) // 2
    total = int(t.sum())
    if total == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z
    amax = int(cnt.max())
    # pairs (p < q) ordered by q, then p: those of q < c are a prefix
    q = torch.arange(amax, device=dev)
    qq = torch.repeat_interleave(q, q)
    pp = torch.cat([torch.arange(int(k), device=dev) for k in range(amax)])
    start = torch.cumsum(cnt, 0) - cnt
    tstart = torch.cumsum(t, 0) - t
    owner = torch.repeat_interleave(torch.arange(n_centers, device=dev), t)
    local = torch.arange(total, device=dev) - tstart[owner]
    return start[owner] + pp[local], start[owner] + qq[local]


# ---------------------------------------------------------------------------
# Energy, forces, virial
# ---------------------------------------------------------------------------


def energy_forces_virial(model: Model, species, pos, lengths, block=32768):
    """(E kcal/mol [], F [n, 3] kcal/mol/A, W [3, 3] kcal/mol) of the
    system `species` [n] at `pos` [n, 3] in an orthorhombic box of side
    `lengths` [3], all in the model's dtype and on its device."""
    dt, dev = model.dtype, model.device
    pos = pos.to(device=dev, dtype=dt)
    lengths = lengths.to(device=dev, dtype=dt)
    species = species.to(device=dev, dtype=torch.int64)
    n = pos.shape[0]
    pi, pj = pair_list(pos, lengths, model.cutoff)
    force = torch.zeros((n, 3), dtype=dt, device=dev)
    dvir = torch.zeros((3, 3), dtype=dt, device=dev)
    energy = torch.zeros((), dtype=dt, device=dev)
    bounds = torch.searchsorted(pi, torch.arange(0, n + block, block,
                                                 device=dev).clamp(max=n))
    for b, c0 in enumerate(range(0, n, block)):
        c1 = min(n, c0 + block)
        p0, p1 = int(bounds[b]), int(bounds[b + 1])
        i, j = pi[p0:p1], pj[p0:p1]
        with torch.enable_grad():
            d = min_image(pos[j] - pos[i], lengths).requires_grad_(True)
            e = block_energy(model, species, i - c0, species[j], d, c0, c1)
            (g,) = torch.autograd.grad(e, d)
        energy = energy + e.detach()
        force.index_add_(0, i, g)
        force.index_add_(0, j, -g)
        dvir += d.detach().T @ g
    c = HARTREE2KCALMOL
    return energy * c, force * c, -0.5 * (dvir + dvir.T) * c


def block_energy(model: Model, species, ci, sj, d, c0, c1):
    """[] energy (Hartree) of the centers c0..c1 from their pairs: local
    center index `ci` [P] (sorted), neighbor species `sj` [P], vectors
    `d` [P, 3]."""
    nb = c1 - c0
    r = torch.sqrt((d * d).sum(-1))
    si = species[c0:c1][ci]
    aev = d.new_zeros(nb * model.aev_len)
    rad = torch.nonzero(r <= model.rcr).flatten()
    at = (ci[rad] * model.aev_len + sj[rad] * model.n_rad)[:, None] \
        + torch.arange(model.n_rad, device=d.device)
    aev = aev.index_add(0, at.flatten(), model.radial(r[rad]).flatten())
    ang = torch.nonzero(r <= model.rca).flatten()
    a, b = _triples(ci[ang], nb)
    a, b = ang[a], ang[b]
    if len(a):
        terms = model.angular(d[a], d[b], r[a], r[b])
        at = (ci[a] * model.aev_len + model.ns * model.n_rad
              + model.tri[sj[a], sj[b]] * model.n_ang)[:, None] \
            + torch.arange(model.n_ang, device=d.device)
        aev = aev.index_add(0, at.flatten(), terms.flatten())
    e = model.network(species[c0:c1], aev.view(nb, model.aev_len)).sum()
    return e + model.repulsion(si, sj, r).sum()
