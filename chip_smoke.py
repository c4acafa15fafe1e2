"""Drive the PyTorch/CUDA port (lammps_ani_torch) on one CUDA card.

Run from the root of the repository, on a machine with one card and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

It imports neither JAX nor lammps_ani_tpu. Phases, each printing one JSON
object per line; any failure raises and the script exits non-zero:

  device   the card as torch and nvidia-smi report it.
  build    nvcc builds lammps_ani_torch/csrc/aev_roll.cu and aev_asn.cu
           for sm_90a, both at once; ptxas's registers per kernel.
  kernels  each of the four AEV kernels against its plain PyTorch version
           on the card, WATER30 x 6^3 (6,480 atoms), in f64 and f32; the
           kernels' backwards against autograd through the plain forwards
           (f64); the whole potential (E, F, W) on the card against the
           plain path on the CPU, WATER30 x 4^3 (1,920 atoms), f64.
  main     the MD main path through the user's entry points (zoo.ani2x,
           Simulation.init_state, Simulation.run): ANI-2x at full width,
           one model, weights drawn from a seed, f32; WATER30 x 15^3 =
           101,250 atoms; dt 0.5 fs, 12-step chunks. The tile was not
           equilibrated under these weights, so 12 chunks of Langevin
           300 K at damp 10 fs bring the temperature to 300 K first; then
           2 warm and 4 timed chunks at damp 100 fs. The launch counts are
           zeroed just before and read just after; the line gives the
           timed window's temperature drift and its change of work.
  timing   each kernel at the main path's shapes (its final state, f32)
           against its plain version: error, ms, plain ms and the bound.
  profile  from the main path's final state: one force evaluation (CUDA
           events), one chunk on the host clock, and one chunk under
           torch.profiler: device ms by group (the AEV kernels, matrix
           products, wing folds, the rest) and the device's idle share.
  asn_kernels  the four asn kernels (csrc/aev_asn.cu: assignment build
           inv and idx, fused step forward, packed angular pairs) against
           their plain versions on the card, WATER30 x 6^3 (6,480 atoms)
           with ANI-2x + XTB repulsion, in f64 and f32: integer outputs
           (tables, overflow, rank2, deficits) exactly, floats within the
           limits below; and atomic_energies_asn on the card against the
           plain path on the CPU (f64).
  asn      the asn path (build_assignment, then atomic_energies_asn) at
           the main path's final state (positions wrapped into the box),
           101,250 atoms, f32, ANI-2x + XTB repulsion, one model, with the
           launch counts zeroed just before and read just after: its grid,
           sections, kpad, caps and tiers; overflow and deficits (both
           must be <= 0); peak memory of that call; rebuild, forward and
           energy ms (CUDA events, three rounds of 10 calls); one rebuild
           + energy call under torch.profiler (device ms by group, idle
           share); the energy against the plain versions on the card;
           with repulsion off, the energies against the roll engine's at
           the same state and weights (held in f64, reported in f32);
           each asn kernel's error, ms, plain ms and bound.

Then one line {"kernels": [...]} (all eight kernels), nvidia-smi's name
and power-limit line, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from lammps_ani_torch import Box, NeighborConfig, Simulation
from lammps_ani_torch.io.lammps_data import LammpsData, replicate
from lammps_ani_torch.md import integrate
from lammps_ani_torch.models import potential as potmod
from lammps_ani_torch.models import zoo
from lammps_ani_torch.ops import _build
from lammps_ani_torch.ops import aev_asn as asn
from lammps_ani_torch.ops import aev_roll as ar
from lammps_ani_torch.ops import cell_roll as crmod
from lammps_ani_torch.ops import neighbors as nbops

ROOT = os.path.dirname(os.path.abspath(__file__))
TILE = os.path.join(ROOT, "examples", "benchmark", "data", "equil_water30.npz")
SOURCE = "lammps_ani_torch/csrc/aev_roll.cu"
ASN_SOURCE = "lammps_ani_torch/csrc/aev_asn.cu"
KERNELS = ("radial_fwd", "radial_bwd", "angular_fwd", "angular_bwd")
ASN_KERNELS = ("build_inv", "build_idx", "step_fused", "packed_fwd")

# The 30-atom water tile (species H=0, O=3) and the masses of the 7 ANI-2x
# species (H, C, N, O, S, F, Cl), g/mol.
WATER30_SPECIES = np.array([3, 0, 0] * 10, np.int64)
MASSES = np.array([1.008, 12.0107, 14.0067, 15.999, 32.06, 18.998403163,
                   35.45])

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, f32 FLOP/s
# outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

# Operations each kernel needs per unit of work, counting every add,
# multiply, compare and transcendental as one (a lower bound):
#   radial fwd, per in-cutoff pair: distance 9, cutoff 5, 16 shifts x 6;
#   radial bwd, per pair: distance 9, cutoff and slope 7, 16 x 10, chain 9;
#   angular, per in-cutoff neighbor (compaction): distance 9, unit
#     vector 4, cutoff 5 (fwd); + 7 for the chain to the lanes (bwd);
#   angular fwd, per slot pair: cosine 8, radial mean 4, 4 e_j x 4,
#     8 angle terms x 8, 32 channels x 2 accumulation, fc12 products 5;
#   angular bwd, per slot pair: the forward terms (100) + chain rule
#     (8 angles x 24, 4 e_j x 8, slot cotangents 14).
OPS = {"radial_fwd": {"pair": 110}, "radial_bwd": {"pair": 185},
       "angular_fwd": {"nbr": 18, "pair": 165},
       "angular_bwd": {"nbr": 25, "pair": 340}}

# Limits of a kernel's error against its plain version: |err| <= atol +
# rtol * scale, where scale is the output's largest magnitude, or for the
# box cotangent dh (a sum over every window lane) the sum of the magnitudes
# of its terms. f32 sums taken in another order differ by a few ulps of
# that scale.
TOL = {torch.float64: (1e-10, 1e-10), torch.float32: (5e-6, 1e-5)}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Systems
# ---------------------------------------------------------------------------


def water_box(rep: int) -> LammpsData:
    """The equilibrated 30-atom tile replicated rep^3 times."""
    z = np.load(TILE)
    bounds = np.stack([z["box_origin"], z["box_origin"]
                       + np.diag(z["box_h"])], 1).astype(np.float64)
    tile = LammpsData(species=WATER30_SPECIES,
                      positions=z["positions"].astype(np.float64),
                      masses_by_type=MASSES, box_bounds=bounds,
                      tilt=np.zeros(3))
    return replicate(tile, rep, rep, rep)


def make_sim(data, dtype, device, integrator=None, rebuild_every=12,
             seed=1):
    n = data.n_atoms
    nbr = NeighborConfig(cutoff=5.1, skin=2.0, k_max=128,
                         ghost_capacity=max(4096, n // 2),
                         use_cell_list=n > 4096, cell_capacity=32,
                         rebuild_every=rebuild_every)
    pot = zoo.ani2x(num_models=1, seed=seed, dtype=dtype, device=device)
    return Simulation(potential=pot, species=data.species,
                      masses=data.masses_by_type[data.species], nbr=nbr,
                      dt=0.5, integrator=integrator, dtype=dtype,
                      device=device)


def make_box(data, dtype, device):
    return Box(h=torch.tensor(data.box_h, dtype=dtype, device=device),
               origin=torch.tensor(data.box_origin, dtype=dtype,
                                   device=device))


# ---------------------------------------------------------------------------
# Kernel inputs, calls and bounds
# ---------------------------------------------------------------------------


def kernel_inputs(sim, state, seed=0):
    """The four kernels' grid inputs at a simulation state (its positions
    and the bins of its last rebuild), as the main path hands them over,
    and seeded cotangents."""
    box, pos, bins = state.box, state.pos, state.bins
    pos_g, sp_g = ar._grid_inputs(bins.inv, pos, bins.species_grid)
    spec = sim.potential.spec
    caps, present_a = ar.effective_caps(spec.aev, spec.angular_caps,
                                        sim.species_counts)
    nc, cap = sp_g.shape
    g = torch.Generator(device=pos.device).manual_seed(seed)
    ga_r = torch.randn((nc, cap, spec.aev.radial_length), generator=g,
                       dtype=pos.dtype, device=pos.device)
    ga_a = torch.randn((nc, cap, spec.aev.angular_length), generator=g,
                       dtype=pos.dtype, device=pos.device)
    return dict(pos_g=pos_g, sp_g=sp_g, h=box.h.contiguous(),
                ncells=sim._roll_grid.ncells, shell=sim._roll_shell,
                spec=spec.aev, caps=caps, present_a=present_a,
                present_r=ar.present_species(spec.aev, sim.species_counts),
                ga_r=ga_r, ga_a=ga_a)


def kernel_calls(k):
    """{name: (kernel call, plain call)} on the same inputs."""
    a = (k["pos_g"], k["sp_g"], k["h"], k["ncells"])
    rad = (k["shell"], k["spec"], k["present_r"])
    ang = (k["spec"], k["caps"], k["present_a"])
    return {
        "radial_fwd": (lambda: ar.radial_fwd(*a, *rad),
                       lambda: ar.radial_fwd_plain(*a, *rad)),
        "radial_bwd": (lambda: ar.radial_bwd(*a, *rad, k["ga_r"]),
                       lambda: ar.radial_bwd_plain(*a, *rad, k["ga_r"])),
        "angular_fwd": (lambda: ar.angular_fwd(*a, *ang),
                        lambda: ar.angular_fwd_plain(*a, *ang)),
        "angular_bwd": (lambda: ar.angular_bwd(*a, *ang, k["ga_a"]),
                        lambda: ar.angular_bwd_plain(*a, *ang, k["ga_a"])),
    }


def _dh_scale(ncells, shell, wing):
    """Sum of |S| |wing| over the lanes: the size of the terms of dh."""
    sh = ar._wrap_shift_tables(ncells, shell, wing.dtype, wing.device).abs()
    nc, n_off = sh.shape[:2]
    cap = wing.shape[1] // n_off
    s_lane = sh[:, :, None, :].expand(nc, n_off, cap, 3).reshape(nc, -1, 3)
    return torch.einsum("nwm,nwc->mc", s_lane, wing.abs()).max()


def compare(name, k, got, ref):
    """Errors of one kernel's outputs against its plain version's:
    {"max_abs_err", "worst_ratio" (err / limit, <= 1 passes), "outputs"}."""
    atol, rtol = TOL[k["pos_g"].dtype]
    if name == "angular_fwd":
        # the deficit is an integer: exact
        if float(got[1]) != float(ref[1]):
            raise AssertionError(f"angular_fwd deficit {float(got[1])} != "
                                 f"plain {float(ref[1])}")
        got, ref, labels = (got[0],), (ref[0],), ("aev",)
    elif name.endswith("_bwd"):
        labels = ("fcen", "wing", "dh")
    else:
        got, ref, labels = (got,), (ref,), ("aev",)
    out, worst, max_err = {}, 0.0, 0.0
    shell = k["shell"] if name.startswith("radial") else 1
    for lab, x, y in zip(labels, got, ref):
        if x.shape != y.shape:
            raise AssertionError(f"{name}.{lab}: shape {tuple(x.shape)} != "
                                 f"{tuple(y.shape)}")
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}.{lab}: non-finite output")
        err = float((x - y).abs().max())
        scale = (float(_dh_scale(k["ncells"], shell, ref[1])) if lab == "dh"
                 else float(y.abs().max()))
        limit = atol + rtol * scale
        out[lab] = {"err": err, "limit": limit}
        worst = max(worst, err / limit)
        max_err = max(max_err, err)
    return {"max_abs_err": max_err, "worst_ratio": worst, "outputs": out}


def work_counts(k):
    """This input's data-dependent work: in-cutoff radial pairs, in-Rca
    angular neighbors kept by the caps, and angular slot pairs."""
    spec = k["spec"]
    nc, cap = k["sp_g"].shape
    cp, cs = ar._candidates(k["ncells"], k["pos_g"], k["sp_g"], k["h"],
                            k["shell"])
    n_off = (2 * k["shell"] + 1) ** 3
    pairs_r = 0
    for rs in ar._row_chunks(nc, cap, cp.shape[1]):
        _, _, in_cut = ar._window_geometry(k["pos_g"][rs], cp[rs], cap,
                                           (n_off - 1) // 2,
                                           spec.radial_cutoff)
        # empty slots are all parked at one point: count real atoms only
        real = ((k["sp_g"][rs] >= 0)[:, :, None]
                & (cs[rs] >= 0)[:, None, :])
        pairs_r += int((in_cut & real).sum())
    cp, cs = ar._candidates(k["ncells"], k["pos_g"], k["sp_g"], k["h"], 1)
    nbrs_a = pairs_a = 0
    for rs in ar._row_chunks(nc, cap, cp.shape[1]):
        _, _, in_cut = ar._window_geometry(k["pos_g"][rs], cp[rs], cap, 13,
                                           spec.angular_cutoff)
        n_s = []
        for s in k["present_a"]:
            c = (in_cut & (cs[rs][:, None, :] == s)).sum(-1)
            n_s.append(torch.clamp(c, max=k["caps"][s]).to(torch.float64))
        for i, a in enumerate(n_s):
            nbrs_a += float(a.sum())
            pairs_a += float((a * (a - 1) / 2).sum())
            for b in n_s[i + 1:]:
                pairs_a += float((a * b).sum())
    return {"radial_pairs": pairs_r, "angular_nbrs": int(nbrs_a),
            "angular_pairs": int(pairs_a)}


def bound(name, k, work):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    over HBM's rate and its operations over the f32 peak. The bytes are
    the real atoms' rows, each read or written once: positions, species
    and the box in; the AEV out (forward); the AEV cotangent in, dpos and
    dh out (backward). The grid's empty slots and the wing slabs are the
    kernels' own layout, not the function's."""
    n = int((k["sp_g"] >= 0).sum())
    fsize = k["pos_g"].element_size()
    width = (k["spec"].radial_length if name.startswith("radial")
             else k["spec"].angular_length)
    nbytes = n * 3 * fsize + n * 4 + 9 * fsize
    if name.endswith("_fwd"):
        nbytes += n * width * fsize + (4 if name == "angular_fwd" else 0)
    else:
        nbytes += n * width * fsize + n * 3 * fsize + 9 * fsize
    ops = OPS[name]
    if name.startswith("radial"):
        n_ops = ops["pair"] * work["radial_pairs"]
    else:
        n_ops = (ops["nbr"] * work["angular_nbrs"]
                 + ops["pair"] * work["angular_pairs"])
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32 * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


def time_ms(fn, reps, warm=1):
    """Device time per call: CUDA events around `reps` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build():
    t0 = time.perf_counter()
    report = _build.build_all()
    regs, fn = {}, None
    for line in "\n".join(r["log"] for r in report.values()).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "Used" in line and "registers" in line:
            regs[fn] = line.split(":", 1)[1].strip()
    names = {}
    for fn, used in regs.items():
        for kname in (*KERNELS, "dh_reduce",
                      *(f"asn_{k}" for k in ASN_KERNELS)):
            if f"{kname}_kernel" in fn:
                suf = ("f64" if f"{kname}_kernelId" in fn else
                       "f32" if f"{kname}_kernelIf" in fn else "any")
                names[f"{kname}_{suf}"] = used
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": names})


def phase_kernels_small(device, rep=6):
    """Kernels vs plain versions at WATER30 x rep^3, f64 and f32, and the
    kernels' backwards vs autograd through the plain forwards (f64)."""
    data = water_box(rep)
    result = {}
    for dtype in (torch.float64, torch.float32):
        sim = make_sim(data, dtype, device)
        state = sim.init_state(data.positions, make_box(data, dtype, device))
        k = kernel_inputs(sim, state)
        errs = {}
        for name, (kern, plain) in kernel_calls(k).items():
            got = kern()
            ref = plain()
            _sync(device)
            errs[name] = compare(name, k, got, ref)
            if errs[name]["worst_ratio"] > 1.0:
                raise AssertionError(f"{name} {dtype}: {errs[name]}")
        result[str(dtype).replace("torch.", "")] = errs
        if dtype == torch.float64:
            result["autograd_f64"] = autograd_check(sim, state)
    emit({"phase": "kernels", "atoms": data.n_atoms,
          "ncells": list(sim._roll_grid.ncells), "cap": sim._roll_grid.cap,
          "shell": sim._roll_shell,
          "angular_caps": list(sim.potential.spec.angular_caps),
          **result})
    return result


def autograd_check(sim, state):
    """dE/dpos and dE/dh of E = sum(aev @ w): the autograd.Functions (the
    backward kernels on the card) against torch.autograd through the plain
    forwards, f64."""
    spec = sim.potential.spec
    grid, counts = sim._roll_grid, sim.species_counts
    box0, pos0, bins = state.box, state.pos, state.bins
    caps, present_a = ar.effective_caps(spec.aev, spec.angular_caps, counts)
    present_r = ar.present_species(spec.aev, counts)
    g = torch.Generator(device=pos0.device).manual_seed(4)
    out = {}
    for channel in ("radial", "angular"):
        width = (spec.aev.radial_length if channel == "radial"
                 else spec.aev.angular_length)
        w = torch.randn((width,), generator=g, dtype=pos0.dtype,
                        device=pos0.device)

        def grads(fn):
            pos = pos0.clone().requires_grad_(True)
            h = box0.h.clone().requires_grad_(True)
            e = torch.sum(fn(pos, Box(h=h, origin=box0.origin)) @ w)
            return torch.autograd.grad(e, (pos, h))

        def function(pos, box):
            if channel == "radial":
                return ar.radial_aev_roll(spec.aev, grid, bins, pos, box,
                                          species_counts=counts,
                                          shell=sim._roll_shell)
            return ar.angular_aev_roll(spec.aev, grid, bins, pos, box,
                                       spec.angular_caps, counts)[0]

        def plain(pos, box):
            pos_g = ar._to_grid_rows(bins.inv, pos, 1e6)
            a = (pos_g, bins.species_grid, box.h, grid.ncells)
            if channel == "radial":
                o = ar.radial_fwd_plain(*a, sim._roll_shell, spec.aev,
                                        present_r)
            else:
                o = ar.angular_fwd_plain(*a, spec.aev, caps, present_a)[0]
            return o[bins.cell, bins.slot]

        dpos_k, dh_k = grads(function)
        dpos_p, dh_p = grads(plain)
        e_pos = float((dpos_k - dpos_p).abs().max())
        e_h = float((dh_k - dh_p).abs().max())
        out[channel] = {"dpos_err": e_pos, "dpos_limit": 1e-9,
                        "dh_err": e_h, "dh_limit": 1e-8}
        if not (e_pos <= 1e-9 and e_h <= 1e-8):
            raise AssertionError(f"autograd {channel}: {out[channel]}")
        del dpos_k, dh_k, dpos_p, dh_p
        torch.cuda.empty_cache()
    return out


def phase_potential(device, rep=4):
    """E, F, W of the whole potential through the kernels on the card
    against the plain path on the CPU, f64, at the same state."""
    data = water_box(rep)
    res = {}
    for dev in (device, "cpu"):
        sim = make_sim(data, torch.float64, dev)
        st = sim.init_state(data.positions,
                            make_box(data, torch.float64, dev))
        res[dev] = (sim, st)
    (sk, stk), (sp, stp) = res[device], res["cpu"]
    same = (sk._roll_grid == sp._roll_grid and sk._roll_shell == sp._roll_shell
            and sk.potential.spec.angular_caps
            == sp.potential.spec.angular_caps)
    e_pe = abs(float(stk.pe) - float(stp.pe)) / abs(float(stp.pe))
    e_f = float((stk.force.cpu() - stp.force).abs().max())
    e_w = float((stk.virial.cpu() - stp.virial).abs().max())
    line = {"phase": "potential", "atoms": data.n_atoms,
            "same_capacities": same, "pe": float(stk.pe),
            "pe_rel_err": e_pe, "pe_limit": 1e-11,
            "force_err": e_f, "force_limit": 1e-9,
            "virial_err": e_w, "virial_limit": 1e-8}
    emit(line)
    if not (same and e_pe <= 1e-11 and e_f <= 1e-9 and e_w <= 1e-8):
        raise AssertionError(f"potential: card vs CPU plain: {line}")


def phase_main(device, rep=15, equil_chunks=12, warm_chunks=2,
               timed_chunks=4, seed=1):
    """The MD main path at 101,250 atoms; returns (sim, state, launches,
    work at the start of the timed window)."""
    data = water_box(rep)
    gen = torch.Generator(device=device).manual_seed(seed)
    chunk = 12
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ar.reset_counts()
    sim = make_sim(data, torch.float32, device,
                   integrator=integrate.Langevin(temp=300.0, damp=10.0,
                                                 generator=gen),
                   rebuild_every=chunk, seed=seed)
    box = make_box(data, torch.float32, device)
    t0 = time.perf_counter()
    state = sim.init_state(data.positions, box, temp=300.0, seed=seed)
    state, equil_rows = sim.run(state, equil_chunks * chunk, thermo_every=1)
    sim.integrator = integrate.Langevin(temp=300.0, damp=100.0,
                                        generator=gen)
    state, warm_rows = sim.run(state, warm_chunks * chunk, thermo_every=1)
    _sync(device)
    t_setup = time.perf_counter() - t0
    regrow_warm = sim.regrow_events
    work_start = work_counts(kernel_inputs(sim, state))
    torch.cuda.empty_cache()
    n_steps = timed_chunks * chunk
    rows, chunk_ms = [], []
    for _ in range(timed_chunks):
        t0 = time.perf_counter()
        state, r = sim.run(state, chunk, thermo_every=1)
        _sync(device)
        chunk_ms.append((time.perf_counter() - t0) * 1e3 / chunk)
        rows += r
    elapsed = sum(chunk_ms) * chunk / 1e3
    launches = dict(ar.LAUNCHES)
    plain = dict(ar.PLAIN_CALLS)
    ms_step = elapsed / n_steps * 1e3
    temps = [r["temp"] for r in rows]
    line = {"phase": "main", "atoms": data.n_atoms, "dtype": "float32",
            "models": 1, "dt_fs": sim.dt, "steps_timed": n_steps,
            "ms_per_step": ms_step, "ms_per_step_by_chunk": chunk_ms,
            "ns_per_day": sim.dt * 1e-6 * 86400.0 / (ms_step * 1e-3),
            "setup_equil_and_warm_s": t_setup,
            "equil": {"chunks": equil_chunks, "damp_fs": 10.0,
                      "temp_first": equil_rows[0]["temp"],
                      "temp_max": max(r["temp"] for r in equil_rows),
                      "temp_last": equil_rows[-1]["temp"]},
            "timed_temp": {"first": temps[0], "last": temps[-1],
                           "min": min(temps), "max": max(temps),
                           "mean": float(np.mean(temps))},
            "timed_pe_first_last": [rows[0]["pe"], rows[-1]["pe"]],
            "work_timed_start": work_start,
            "regrow_events_warm": regrow_warm,
            "regrow_events_timed": sim.regrow_events - regrow_warm,
            "ncells": list(sim._roll_grid.ncells),
            "roll_cap": sim._roll_grid.cap, "radial_shell": sim._roll_shell,
            "angular_caps": list(sim.potential.spec.angular_caps),
            "k_max": sim._k_max, "first_row": equil_rows[0],
            "last_row": rows[-1], "launches": launches,
            "plain_calls": plain,
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if torch.device(device).type == "cuda"
                            else None)}
    emit(line)
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{launches}")
    if any(plain.values()):
        raise AssertionError(f"a plain version ran on the main path: {plain}")
    finite = all(np.isfinite(r[key]) for r in equil_rows + warm_rows + rows
                 for key in ("pe", "ke", "temp", "press"))
    if not (finite and bool(torch.isfinite(state.force).all())
            and bool(torch.isfinite(state.pos).all())):
        raise AssertionError("main path: non-finite pe, forces, positions "
                             "or temperature")
    return sim, state, launches, work_start


def phase_timing(sim, state, launches, work_start):
    """Each kernel at the main path's shapes (f32): error against its plain
    version, its time and the plain version's, and its bound."""
    k = kernel_inputs(sim, state)
    work = work_counts(k)
    rows = []
    for name, (kern, plain) in kernel_calls(k).items():
        got, ref = kern(), plain()
        _sync(k["pos_g"].device)
        err = compare(name, k, got, ref)
        if err["worst_ratio"] > 1.0:
            raise AssertionError(f"{name} at the main path's shapes: {err}")
        b_ms, b_by = bound(name, k, work)
        del got, ref
        ms = time_ms(kern, reps=10, warm=2)
        plain_ms = time_ms(plain, reps=2, warm=1)
        torch.cuda.empty_cache()
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": ar.REPLACES[name].split()[0],
            "launches": launches[name], "max_abs_err": err["max_abs_err"],
            "err_over_limit": err["worst_ratio"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    emit({"phase": "timing", "ncells": list(k["ncells"]),
          "cap": int(k["sp_g"].shape[1]),
          "atoms": int((k["sp_g"] >= 0).sum()), "work": work,
          "work_change_over_timed_window": {
              key: work[key] / work_start[key] - 1.0 for key in work},
          "outputs": {r["name"]: r for r in rows}})
    return rows


PROFILE_GROUPS = (
    ("aev_kernels", ("radial_fwd_kernel", "radial_bwd_kernel",
                     "angular_fwd_kernel", "angular_bwd_kernel",
                     "dh_reduce_kernel")),
    ("matmul", ("gemm", "Gemm", "cutlass", "sm90_xmma", "ampere_",
                "Kernel2")),
    ("roll_fold", ("roll",)))


def _busy_ms(intervals):
    """Length of the union of [start, end) intervals (microseconds)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def phase_profile(sim, state):
    """Where one MD step spends its time, from the main path's final
    state: one force evaluation (CUDA events), one chunk on the host
    clock, and one chunk under torch.profiler. The idle share is 1 -
    (device busy time of the profiled chunk) / (host time of the
    unprofiled chunk): the profiler's own host overhead stretches the
    profiled chunk's wall time. A chunk that overflowed a capacity runs
    twice (regrow, then again), so both chunks are taken again until one
    runs without a regrow."""
    from torch.profiler import ProfilerActivity, profile

    chunk = sim.nbr.rebuild_every
    f_ms = time_ms(lambda: sim._forces(state.pos, state.box, state.bins),
                   reps=5, warm=1)
    regrows = 0
    for _ in range(4):
        before = sim.regrow_events
        t0 = time.perf_counter()
        state, _ = sim.run(state, chunk)
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = sim.run(state, chunk)
            torch.cuda.synchronize()
        if sim.regrow_events == before:
            break
        regrows += sim.regrow_events - before
    else:
        raise AssertionError("profile: every chunk regrew a capacity")
    busy, groups, top = device_time(prof, chunk, PROFILE_GROUPS)
    emit({"phase": "profile", "steps": chunk, "force_eval_ms": f_ms,
          "regrows_skipped": regrows,
          "angular_caps": list(sim.potential.spec.angular_caps),
          "unprofiled_ms_per_step": chunk_ms / chunk,
          "device_busy_ms_per_step": busy,
          "device_idle_share": 1.0 - busy * chunk / chunk_ms,
          "device_ms_per_step_by_group": groups,
          "top_kernels_ms_per_step": top})


def device_time(prof, calls, group_keys):
    """(device busy ms, device ms by group, the 25 largest kernels' ms),
    each per call, from a torch.profiler run over `calls` calls."""
    by_name, intervals = {}, []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = ev.time_range.end - ev.time_range.start
        by_name[ev.name] = by_name.get(ev.name, 0.0) + dur / 1e3
        intervals.append((ev.time_range.start, ev.time_range.end))
    groups = {}
    for name, ms in by_name.items():
        g = next((g for g, keys in group_keys
                  if any(key in name for key in keys)), "other")
        groups[g] = groups.get(g, 0.0) + ms / calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    return (_busy_ms(intervals) / calls, groups,
            [[n[:120], ms / calls] for n, ms in top])


# ---------------------------------------------------------------------------
# The asn path (ops/aev_asn.py): state, kernel inputs, bounds
# ---------------------------------------------------------------------------

# Keep radius and minimum bin side of the asn grid: Rcr + skin.
KEEP_R = 5.1 + 2.0
# Margins of the JAX package's asn engine (md/simulation.py): bin cap
# +2 +4 slots, sections x1.1, angular caps x1.1 + 2 (+4 if <= 10), tier
# rows x1.06 + 64 and, for the last tier, x1.3 + 4096.
SEC_MARGIN, CAP_MARGIN, ROLL_CAP_MARGIN = 1.1, 1.1, 4

# Operations per unit of work, counted as in OPS above:
#   build_inv, per real candidate of a real center's 27-bin window:
#     distance 8, keep test 1, species test 1;
#   build_idx, per table lane: load and compare 2;
#   step_fused, per assigned lane: gather and distance 10; per lane within
#     Rcr: cutoff 5, 16 shifts x 6, section sum; per lane within the
#     repulsion cutoff: 30; per kept lane within Rca: slot fields 20;
#   packed_fwd, per slot pair of filled slots: as angular_fwd's pair, 165.
ASN_OPS = {"build_inv": {"lane": 10}, "build_idx": {"lane": 2},
           "step_fused": {"lane": 10, "rcr": 110, "rep": 30, "kept": 20},
           "packed_fwd": {"pair": 165}}


def _ceil4(x) -> int:
    return int(-(-int(x) // 4) * 4)


def sorted_water(rep: int):
    """WATER30 x rep^3 with atoms sorted by species (the sorted MLP's
    order): (species, positions, data)."""
    data = water_box(rep)
    order = np.argsort(data.species, kind="stable")
    return data.species[order], data.positions[order], data


def asn_degrees(grid, bins, pos, box, spec):
    """Neighbor counts of every real atom by species: within Rca ([n, S],
    the tier search's matrix), the per-species maximum within the keep
    radius (the sections), and the real (center, candidate) lanes of the
    27-bin windows, within the keep radius and within Rcr."""
    pos_g, sp_g = ar._grid_inputs(bins.inv, pos, bins.species_grid)
    cp, cs = ar._candidates(grid.ncells, pos_g, sp_g, box.h, 1)
    nc, cap = sp_g.shape
    n_sp = spec.num_species
    cnt = torch.zeros((nc, cap, n_sp), dtype=torch.int64, device=pos.device)
    keep_max = torch.zeros(n_sp, dtype=torch.int64, device=pos.device)
    lanes = {"window": 0, "keep": 0, "rcr": 0}
    for rs in ar._row_chunks(nc, cap, cp.shape[1]):
        _, dist, in_keep = ar._window_geometry(pos_g[rs], cp[rs], cap, 13,
                                               KEEP_R)
        real = (sp_g[rs] >= 0)[:, :, None] & (cs[rs] >= 0)[:, None, :]
        lanes["window"] += int(real.sum())
        in_keep = in_keep & real
        lanes["keep"] += int(in_keep.sum())
        lanes["rcr"] += int((in_keep & (dist <= spec.radial_cutoff)).sum())
        in_ang = in_keep & (dist <= spec.angular_cutoff)
        for s in range(n_sp):
            m = (cs[rs] == s)[:, None, :]
            cnt[rs, :, s] = (in_ang & m).sum(-1)
            keep_max[s] = torch.maximum(keep_max[s],
                                        (in_keep & m).sum(-1).max())
        del dist, in_keep, in_ang, real
    return cnt[bins.cell, bins.slot], keep_max.cpu().numpy(), lanes


def derive_tiers(cnt, caps, n):
    """Occupancy tiers as the JAX package's asn engine derives them (three
    tiers, packed layout, from 4,096 atoms)."""
    if n < 4096:
        return None
    ladder = asn.search_tier_ladder(cnt, caps, max_pre=2)
    if ladder is not None:
        tiers, used = [], 0
        for caps_t, n_t in ladder:
            tiers.append((tuple(caps_t), min(int(n_t * 1.06) + 64, n)))
            used += n_t
        tiers.append((tuple(caps), min(int((n - used) * 1.3) + 4096, n)))
        return tuple(tiers)
    res = asn.search_tiers(cnt, caps)
    if res is None:
        return None
    caps0, n0 = res
    return ((tuple(caps0), min(int(n0 * 1.06) + 64, n)),
            (tuple(caps), min(int((n - n0) * 1.3) + 256, n)))


def asn_setup(species, pos, box, spec):
    """The asn engine's static state for these positions: the coarse grid
    (bin side >= Rcr + skin) and its bins, sections, kpad, angular caps and
    tiers, sized with the JAX package's margins."""
    h = box.h.detach().cpu().numpy().astype(np.float64)
    probe = crmod.RollGrid.for_box(h, KEEP_R, 64)
    occ = int(crmod.build_bins(probe, pos, species, box).count_max)
    grid = crmod.RollGrid(ncells=probe.ncells,
                          cap=_ceil4(occ + 2 + ROLL_CAP_MARGIN))
    bins = crmod.build_bins(grid, pos, species, box)
    cnt, keep_max, lanes = asn_degrees(grid, bins, pos, box, spec)
    sections = asn.sections_from_degrees(keep_max, SEC_MARGIN)
    kpad = asn._round_lane(sum(k for _, k in sections) + 1)
    deg = cnt.max(0).values.cpu().numpy()
    caps = tuple(0 if d == 0 else _ceil4(
        int(d * CAP_MARGIN + 2 + (4 if d * CAP_MARGIN <= 10 else 0)))
        for d in deg)
    cnt_np = cnt.cpu().numpy()
    return dict(grid=grid, bins=bins, sections=sections, kpad=kpad,
                caps=caps, tiers=derive_tiers(cnt_np, caps, len(cnt_np)),
                cnt=cnt_np, lanes=lanes)


def asn_inputs(st, pos, box, spec):
    """The four asn kernels' inputs as the path hands them over: grid
    inputs; inv and idx (plain, the common inputs of build_idx and
    step_fused); and every packed_fwd call of one forward (one per tier),
    recorded from the pair stage."""
    grid, bins = st["grid"], st["bins"]
    pos_g, sp_g = ar._grid_inputs(bins.inv, pos, bins.species_grid)
    h = box.h.contiguous()
    inv, _ = asn.build_inv_plain(pos_g, sp_g, h, grid.ncells, st["sections"],
                                 st["kpad"], KEEP_R)
    idx = asn.build_idx_plain(inv, st["kpad"])
    _, cmp, _, deficit = asn.step_fused_plain(
        pos_g, sp_g, h, idx, grid.ncells, spec.aev, st["sections"],
        st["caps"], spec.repulsion)
    calls = []

    def record(cat, aev_spec, caps_t, a_offs):
        calls.append((cat, caps_t, a_offs))
        return cat.new_zeros((cat.shape[0], 0))

    n = bins.cell.shape[0]
    asn._angular_pair_stage(spec.aev, st["sections"], st["caps"],
                            st["tiers"], n, cmp, deficit.to(pos.dtype),
                            bins.cell, bins.slot, {"packed": record})
    return dict(pos_g=pos_g, sp_g=sp_g, h=h, inv=inv, idx=idx, calls=calls,
                ncells=grid.ncells, spec=spec, st=st)


def asn_calls(k):
    """{name: (kernel call, plain call)} on the same inputs."""
    st, spec = k["st"], k["spec"]
    g = (k["pos_g"], k["sp_g"], k["h"], k["ncells"])
    build = (st["sections"], st["kpad"], KEEP_R)
    step = (k["idx"], k["ncells"], spec.aev, st["sections"], st["caps"],
            spec.repulsion)
    g3 = g[:3]
    return {
        "build_inv": (lambda: asn.build_inv(*g, *build),
                      lambda: asn.build_inv_plain(*g, *build)),
        "build_idx": (lambda: asn.build_idx(k["inv"], st["kpad"]),
                      lambda: asn.build_idx_plain(k["inv"], st["kpad"])),
        "step_fused": (lambda: asn.step_fused(*g3, *step),
                       lambda: asn.step_fused_plain(*g3, *step)),
        "packed_fwd": (
            lambda: [asn.packed_fwd(c, spec.aev, ct, ao)
                     for c, ct, ao in k["calls"]],
            lambda: [asn.packed_fwd_plain(c, spec.aev, ct, ao)
                     for c, ct, ao in k["calls"]]),
    }


# which outputs of each asn kernel are integers (compared exactly)
ASN_OUTPUTS = {"build_inv": (("inv", True), ("ovf", True)),
               "build_idx": (("idx", True),),
               "step_fused": (("rad", False), ("cmp", False),
                              ("rank2", True), ("deficit", True))}


def asn_compare(name, got, ref, dtype):
    """Integer outputs must be equal; floats within TOL of the output's
    largest magnitude. Raises on a mismatch."""
    atol, rtol = TOL[dtype]
    if name == "packed_fwd":
        labels = tuple((f"tier{i}", False) for i in range(len(got)))
    elif name == "build_idx":
        got, ref, labels = (got,), (ref,), ASN_OUTPUTS[name]
    else:
        labels = ASN_OUTPUTS[name]
    out, worst, max_err = {}, 0.0, 0.0
    for (lab, exact), x, y in zip(labels, got, ref):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{name}.{lab}: {tuple(x.shape)} {x.dtype} "
                                 f"!= plain {tuple(y.shape)} {y.dtype}")
        if exact:
            n_diff = int((x != y).sum())
            out[lab] = {"mismatches": n_diff}
            if n_diff:
                raise AssertionError(f"{name}.{lab}: {n_diff} entries differ "
                                     "from the plain version")
            continue
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}.{lab}: non-finite output")
        err = float((x - y).abs().max()) if x.numel() else 0.0
        limit = atol + rtol * (float(y.abs().max()) if y.numel() else 0.0)
        out[lab] = {"err": err, "limit": limit}
        worst = max(worst, err / limit)
        max_err = max(max_err, err)
    if worst > 1.0:
        raise AssertionError(f"{name} {dtype}: {out}")
    return {"max_abs_err": max_err, "worst_ratio": worst, "outputs": out}


def asn_bound(name, k, n):
    """(bound_ms, bound_by) of one asn kernel call (build_inv, build_idx,
    step_fused) or of the packed_fwd calls of one forward, from this run's
    data. Bytes: the real atoms' rows, each read or written once
    (positions, species and the box in; inv rows out and in, idx rows out
    and in; rad, the packed slots and rank2 out; each packed row's 5 slot
    fields in and its columns out). Operations: ASN_OPS per real window
    lane, table lane, assigned, in-cutoff or kept lane, or slot pair."""
    st = k["st"]
    f = k["pos_g"].element_size()
    cap = k["sp_g"].shape[1]
    wpad, kpad = asn._round_lane(27 * cap), st["kpad"]
    lanes, ops = st["lanes"], ASN_OPS[name]
    a_offs, atot = asn._a_offsets(st["sections"], st["caps"])
    base_in = n * (3 * f + 4) + 9 * f
    if name == "build_inv":
        nbytes = base_in + n * wpad * 2
        n_ops = ops["lane"] * lanes["window"]
    elif name == "build_idx":
        nbytes = n * (wpad + kpad) * 2
        n_ops = ops["lane"] * n * (wpad + kpad)
    elif name == "step_fused":
        srl = len(st["sections"]) * 16
        nbytes = (base_in + n * kpad * 2 + n * (srl + 1) * f
                  + n * 6 * atot * f + n * kpad * 4)
        kept = np.minimum(st["cnt"], np.asarray(st["caps"])[None]).sum()
        n_ops = (ops["lane"] * lanes["keep"]
                 + (ops["rcr"] + ops["rep"]) * lanes["rcr"]
                 + ops["kept"] * int(kept))
    else:
        ncols = len(asn.present_channels(k["spec"].aev, st["caps"],
                                         st["sections"])) * 32
        nbytes = n * (5 * atot + ncols) * f
        kk = np.minimum(st["cnt"], np.asarray(st["caps"])[None]).astype(
            np.float64)
        pairs = 0.0
        present = [s for s in range(kk.shape[1]) if st["caps"][s]]
        for i, s in enumerate(present):
            pairs += float((kk[:, s] * (kk[:, s] - 1) / 2).sum())
            for t in present[i + 1:]:
                pairs += float((kk[:, s] * kk[:, t]).sum())
        n_ops = ops["pair"] * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32 * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


def _to_cpu_state(st, a):
    bins_c = crmod.RollBins(**{f.name: getattr(st["bins"], f.name).cpu()
                               for f in dataclasses.fields(crmod.RollBins)})
    asn_c = asn.Assignment(idx=a.idx.cpu(), inv=a.inv.cpu(), ovf=a.ovf.cpu(),
                           ovf_sec=a.ovf_sec.cpu())
    return (st["grid"], bins_c, asn_c, st["sections"], st["tiers"])


def phase_asn_kernels(device, rep=6):
    """The four asn kernels against their plain versions at WATER30 x
    rep^3 (f64 and f32), and atomic_energies_asn on the card against the
    plain path on the CPU (f64)."""
    species, pos_np, data = sorted_water(rep)
    counts = tuple(int((species == s).sum()) for s in range(7))
    result = {}
    for dtype in (torch.float64, torch.float32):
        pot = zoo.ani2x(num_models=1, seed=1, dtype=dtype, device=device,
                        repulsion=True)
        box = make_box(data, dtype, device)
        sp_t = torch.as_tensor(species, device=device)
        pos = nbops.wrap_positions(torch.as_tensor(pos_np, dtype=dtype,
                                                   device=device), box)
        st = asn_setup(sp_t, pos, box, pot.spec.aev)
        pot = pot.with_spec(dataclasses.replace(pot.spec,
                                                angular_caps=st["caps"]))
        k = asn_inputs(st, pos, box, pot.spec)
        errs = {}
        for name, (kern, plain) in asn_calls(k).items():
            got = kern()
            ref = plain()
            _sync(device)
            errs[name] = asn_compare(name, got, ref, dtype)
            del got, ref
        result[str(dtype).replace("torch.", "")] = errs
        if dtype == torch.float64:
            result["energies_card_vs_cpu_f64"] = asn_energy_vs_cpu(
                pot, sp_t, pos, box, st, counts)
        del k
        torch.cuda.empty_cache()
    emit({"phase": "asn_kernels", "atoms": data.n_atoms,
          "ncells": list(st["grid"].ncells), "cap": st["grid"].cap,
          "sections": [list(x) for x in st["sections"]], "kpad": st["kpad"],
          "angular_caps": list(st["caps"]),
          "tiers": st["tiers"] and [[list(c), r] for c, r in st["tiers"]],
          **result})


def asn_energy_vs_cpu(pot, species, pos, box, st, counts):
    """atomic_energies_asn (kernels, on the card) against the same function
    on the CPU (plain versions), f64, with the same assignment."""
    a = asn.build_assignment(st["grid"], st["bins"], pos, box,
                             st["sections"], st["kpad"], KEEP_R)
    state = (st["grid"], st["bins"], a, st["sections"], st["tiers"])
    e_k, d_k = potmod.atomic_energies_asn(pot, species, pos, box, state,
                                          counts)
    pot_c = potmod.ANIPotential(pot.spec, pot.params).to("cpu")
    e_p, d_p = potmod.atomic_energies_asn(
        pot_c, species.cpu(), pos.cpu(), box.to(device="cpu"),
        _to_cpu_state(st, a), counts)
    err = float((e_k.cpu() - e_p).abs().max())
    line = {"atoms": int(e_p.shape[0]), "energy": float(e_p.sum()),
            "max_atom_err": err, "limit": 1e-10,
            "deficit_card": d_k.cpu().tolist(), "deficit_cpu": d_p.tolist()}
    if not (err <= 1e-10 and torch.equal(d_k.cpu(), d_p)):
        raise AssertionError(f"asn energies card vs CPU: {line}")
    return line


def phase_asn(device, sim, state, reps=10):
    """The asn path at the main path's final state (f32, ANI-2x + XTB
    repulsion, the main path's weights); returns the kernels' rows."""
    torch.cuda.empty_cache()
    dtype = torch.float32
    species, box = sim.species, state.box
    # the main path wraps positions only at its rebuilds; the asn bins and
    # assignment are built anew here, from positions wrapped into the box
    pos = nbops.wrap_positions(state.pos, box)
    counts = sim.species_counts
    n = int(species.shape[0])
    t0 = time.perf_counter()
    pot = zoo.ani2x(num_models=1, seed=1, dtype=dtype, device=device,
                    repulsion=True)
    st = asn_setup(species, pos, box, pot.spec.aev)
    pot = pot.with_spec(dataclasses.replace(pot.spec,
                                            angular_caps=st["caps"]))
    _sync(device)
    t_setup = time.perf_counter() - t0
    grid, bins, sections, kpad = (st["grid"], st["bins"], st["sections"],
                                  st["kpad"])

    # the path as a user calls it, with the counts zeroed just before
    resident = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    asn.reset_counts()
    a = asn.build_assignment(grid, bins, pos, box, sections, kpad, KEEP_R)
    a_state = (grid, bins, a, sections, st["tiers"])
    e, deficit = potmod.atomic_energies_asn(pot, species, pos, box, a_state,
                                            counts)
    _sync(device)
    launches, plain = dict(asn.LAUNCHES), dict(asn.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if any(v == 0 for v in launches.values()) or any(plain.values()):
        raise AssertionError(f"asn path: launches {launches}, plain calls "
                             f"{plain}")
    ovf, dmax = float(a.ovf), float(deficit.max())
    if not (ovf <= 0 and dmax <= 0):
        raise AssertionError(f"asn path: overflow {ovf}, deficit {dmax}")

    # three rounds of `reps` calls each, to show the spread
    rebuild_ms = [time_ms(lambda: asn.build_assignment(
        grid, bins, pos, box, sections, kpad, KEEP_R), reps=reps)
        for _ in range(3)]
    forward_ms = [time_ms(lambda: asn.aev_asn_fused(
        pot.spec.aev, grid, bins, a, pos, box, sections, st["caps"],
        tiers=st["tiers"], repulsion=pot.spec.repulsion), reps=reps)
        for _ in range(3)]
    energy_ms = [time_ms(lambda: potmod.atomic_energies_asn(
        pot, species, pos, box, a_state, counts), reps=reps)
        for _ in range(3)]
    profile = asn_profile(lambda: potmod.atomic_energies_asn(
        pot, species, pos, box, (grid, bins, asn.build_assignment(
            grid, bins, pos, box, sections, kpad, KEEP_R), sections,
            st["tiers"]), counts))

    # the same function through the plain versions on the card
    e_p, _ = potmod.atomic_energies_asn(pot, species, pos, box, a_state,
                                        counts, plain=True)
    atol, rtol = TOL[dtype]
    e_lim = atol + rtol * float(e_p.abs().max())
    e_err = float((e - e_p).abs().max())
    del e_p
    vs_roll = norep_vs_roll(sim, state, st, a, device)

    rows, timing = [], {}
    k = asn_inputs(st, pos, box, pot.spec)
    for name, (kern, plain_fn) in asn_calls(k).items():
        err = asn_compare(name, kern(), plain_fn(), dtype)
        _sync(device)
        b_ms, b_by = asn_bound(name, k, n)
        ms = time_ms(kern, reps=reps, warm=1)
        plain_ms = time_ms(plain_fn, reps=2, warm=1)
        torch.cuda.empty_cache()
        timing[name] = {**err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by}
        rows.append({
            "name": name, "route": "cuda", "source": ASN_SOURCE,
            "replaces": asn.REPLACES[name].split()[0],
            "launches": launches[name], "max_abs_err": err["max_abs_err"],
            "err_over_limit": err["worst_ratio"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    line = {"phase": "asn", "atoms": n, "dtype": "float32", "models": 1,
            "repulsion": True, "ncells": list(grid.ncells), "cap": grid.cap,
            "sections": [list(x) for x in sections], "kpad": kpad,
            "angular_caps": list(st["caps"]),
            "tiers": st["tiers"] and [[list(c), r] for c, r in st["tiers"]],
            "packed_calls": [[list(ct), int(c.shape[0])]
                             for c, ct, _ in k["calls"]],
            "window_lanes": st["lanes"], "setup_s": t_setup,
            "ovf": ovf, "ovf_sec": a.ovf_sec.tolist(),
            "deficit": deficit.tolist(), "launches": launches,
            "rebuild_ms": rebuild_ms, "forward_ms": forward_ms,
            "energy_ms": energy_ms, "energy": float(e.double().sum()),
            "energy_vs_plain": {"max_atom_err": e_err, "limit": e_lim},
            "norep_vs_roll": vs_roll, "resident_gb": resident,
            "peak_mem_gb": peak, "profile": profile, "kernels": timing}
    emit(line)
    if not e_err <= e_lim:
        raise AssertionError(f"asn energies vs plain: {e_err} > {e_lim}")
    return rows


ASN_PROFILE_GROUPS = (
    ("asn_kernels", ("asn_",)),
    ("matmul", PROFILE_GROUPS[1][1]))


def asn_profile(fn, calls=5):
    """Where one rebuild + energy call of the asn path spends its time:
    host ms per call (synchronized), and under torch.profiler the device
    busy ms by group and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy, groups, top = device_time(prof, calls, ASN_PROFILE_GROUPS)
    return {"calls": calls, "host_ms": host_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / host_ms,
            "device_ms_by_group": groups, "top_kernels_ms": top[:12]}


def norep_vs_roll(sim, state, st, a, device):
    """Per-atom energies of the asn path without the repulsion term
    against the roll engine's, at the same state, weights, bins and
    assignment: in f64, held to TOL (both sum the same terms in another
    order), and in f32, reported (its difference is that of two f32
    summation orders through the MLP, not of the algorithms)."""
    species, counts = sim.species, sim.species_counts
    out = {}
    for dtype in (torch.float64, torch.float32):
        box = Box(h=state.box.h.to(dtype), origin=state.box.origin.to(dtype))
        # the roll engine's bins are those of its last rebuild, which
        # hold the positions as they are now (not wrapped since); the
        # asn bins were built from wrapped positions
        pos = {"roll": state.pos.to(dtype)}
        pos["asn"] = nbops.wrap_positions(pos["roll"], box)
        e = {}
        for name, caps in (("asn", st["caps"]),
                           ("roll", sim.potential.spec.angular_caps)):
            pot = zoo.ani2x(num_models=1, seed=1, dtype=dtype, device=device)
            pot = pot.with_spec(dataclasses.replace(pot.spec,
                                                    angular_caps=caps))
            if name == "asn":
                e[name], d = potmod.atomic_energies_asn(
                    pot, species, pos[name], box,
                    (st["grid"], st["bins"], a, st["sections"], st["tiers"]),
                    counts)
            else:
                e[name], d = potmod.atomic_energies_roll(
                    pot, species, pos[name], box, sim._roll_grid, state.bins,
                    counts, radial_shell=sim._roll_shell)
            if float(d.max()) > 0:
                raise AssertionError(f"{name} path {dtype}: deficit {d}")
        atol, rtol = TOL[dtype]
        out[str(dtype).replace("torch.", "")] = {
            "max_atom_err": float((e["asn"] - e["roll"]).abs().max()),
            "limit": atol + rtol * float(e["roll"].abs().max())}
        del e
    res = out["float64"]
    if not res["max_atom_err"] <= res["limit"]:
        raise AssertionError(f"asn vs roll energies (f64): {res}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the card", file=sys.stderr)
        return 1
    device = "cuda"
    smi = nvidia_smi_line()
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    phase_build()
    phase_kernels_small(device)
    phase_potential(device)
    phase_asn_kernels(device)
    sim, state, launches, work_start = phase_main(device)
    rows = phase_timing(sim, state, launches, work_start)
    phase_profile(sim, state)
    rows += phase_asn(device, sim, state)
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
