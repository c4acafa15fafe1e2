"""Drive the PyTorch/CUDA port (lammps_ani_torch) on one CUDA card.

Run from the root of the repository, on a machine with one card and the
CUDA toolkit (nvcc):

    python3 chip_smoke.py

It imports neither JAX nor lammps_ani_tpu. Phases, each printing one JSON
object per line; any failure raises and the script exits non-zero:

  device   the card as torch and nvidia-smi report it.
  build    nvcc builds lammps_ani_torch/csrc/aev_roll.cu for sm_90a.
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

Then one line {"kernels": [...]}, nvidia-smi's name and power-limit line,
and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
from lammps_ani_torch.models import zoo
from lammps_ani_torch.ops import _build
from lammps_ani_torch.ops import aev_roll as ar

ROOT = os.path.dirname(os.path.abspath(__file__))
TILE = os.path.join(ROOT, "examples", "benchmark", "data", "equil_water30.npz")
SOURCE = "lammps_ani_torch/csrc/aev_roll.cu"
KERNELS = ("radial_fwd", "radial_bwd", "angular_fwd", "angular_bwd")

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
        for kname in (*KERNELS, "dh_reduce"):
            if f"{kname}_kernelI" in fn:
                names[f"{kname}_{'f64' if 'kernelId' in fn else 'f32'}"] = used
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
    by_name, intervals = {}, []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = ev.time_range.end - ev.time_range.start
        by_name[ev.name] = by_name.get(ev.name, 0.0) + dur / 1e3
        intervals.append((ev.time_range.start, ev.time_range.end))
    groups = {}
    for name, ms in by_name.items():
        g = next((g for g, keys in PROFILE_GROUPS
                  if any(key in name for key in keys)), "other")
        groups[g] = groups.get(g, 0.0) + ms / chunk
    busy = _busy_ms(intervals)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    emit({"phase": "profile", "steps": chunk, "force_eval_ms": f_ms,
          "regrows_skipped": regrows,
          "angular_caps": list(sim.potential.spec.angular_caps),
          "unprofiled_ms_per_step": chunk_ms / chunk,
          "device_busy_ms_per_step": busy / chunk,
          "device_idle_share": 1.0 - busy / chunk_ms,
          "device_ms_per_step_by_group": groups,
          "top_kernels_ms_per_step": [[n[:120], ms / chunk]
                                      for n, ms in top]})


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
    sim, state, launches, work_start = phase_main(device)
    rows = phase_timing(sim, state, launches, work_start)
    phase_profile(sim, state)
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
