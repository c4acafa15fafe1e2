"""The port's benchmark: one cell of BENCHMARK.json, one run.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. A cell names a configuration (`portbench/configs/<config>.json`) and
a traffic mix (`portbench/workloads/<traffic>.json`); its correctness
limits are `portbench/limits/<cell>.json`. Set-up (from the process's
start to the first timed step): the system and the weights from the
seed, the port's Simulation, `init_state` (the kernels built on first use
into the checkout), the traffic's warm-up. Then the window: chunks of
`rebuild_every` steps for `--seconds` (portbench/md.py). With `--trace 1`
two chunks inside it run under torch.profiler with the device's activity
alone, and the line carries the per-layer metrics read from them
(`portbench/metrics/<name>.py`) and the breakdown, whose idle gaps come
from one more chunk traced with the host's operations; otherwise the
end-to-end ones. Then, with the program's state freed, the
check (portbench/check.py). The last line of standard output is the
result; the numbers compared, each beside its limit, end standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "lammps_ani_tpu")


def process_age_s() -> float:
    """Seconds since this process started, at the time of the call (from
    /proc; 0 where it cannot be read)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_T0 = process_age_s()


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def cell(name: str) -> dict:
    """The cell's entry of BENCHMARK.json with its configuration, traffic
    and limits files read."""
    bench = load_json(ROOT, "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return {"bench": bench, "workload": wl,
            "cfg": load_json(ROOT, cfg_entry["file"]),
            "traffic": load_json(HERE, "workloads", f"{wl['traffic']}.json"),
            "limits": load_json(HERE, "limits", f"{name}.json")}


def cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(HERE, "_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def nvidia_smi() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def per_layer(c, win, run, system) -> tuple:
    """(per-layer metrics, busy_s, window_s, breakdown) of the traced
    chunks."""
    import torch

    from . import metrics as metmod
    from . import trace as trmod
    from .counts import neighbors, work as workmod

    t = win.traced
    lengths = torch.as_tensor(system.lengths, dtype=torch.float64)
    order = torch.as_tensor(run.sim.order)
    species = torch.as_tensor(system.species)[order]
    md = c["traffic"]["md"]
    works = [neighbors.work(c["cfg"], md, species.to(st.pos.device),
                            st.pos, lengths.to(st.pos.device))
             for st in (t.before, t.after)]
    ctx = metmod.Context(trace=t.trace, steps=t.steps, regrows=win.regrows,
                         work=neighbors.mean_work(works), cfg=c["cfg"],
                         tables=workmod.load(c["cfg"]["name"]),
                         groups=workmod.groups())
    out = {}
    for m in c["bench"]["per_layer"]:
        v = metmod.read(m["name"], ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    breakdown = {"device_ops": trmod.top(trmod.device_us_by_name(t.trace)),
                 "idle_gaps": trmod.top(trmod.idle_gaps_us(t.gaps))}
    return (out, trmod.busy_us(t.trace) * 1e-6, t.trace.window_us * 1e-6,
            breakdown)


@dataclasses.dataclass
class Driven:
    """A run's set-up and window (`drive`), until `take_case` frees the
    program's state for the check."""

    system: object
    params: object
    run: object  # md.Run
    win: object  # md.Window
    init_s: float
    setup_s: float  # the process's start to the window's first step


def drive(c: dict, seed: int, seconds: float, dev, trace_chunks=None,
          log=None) -> Driven:
    """The cell's set-up (the system and weights, the port's Simulation,
    `init_state`, the warm-up) and its window, as the check takes them;
    `log(text)` is given the set-up's times and the window's summary."""
    from . import md, system as sysmod, weights

    cfg, traffic = c["cfg"], c["traffic"]
    stamps = [("start", AGE_AT_T0 + (time.perf_counter() - T0))]

    def stamp(what):
        stamps.append((what, AGE_AT_T0 + (time.perf_counter() - T0)))

    system = sysmod.build(traffic, cfg)
    params = weights.draw(cfg, dev)
    stamp("system and weights")
    run, init_s = md.build(cfg, traffic, system, params, seed, dev)
    stamp("Simulation and init_state")
    warm = md.warm_up(run, traffic)
    stamp("warm-up")
    kinds = dict(run.sim.regrow_kinds)
    win = md.window(run, traffic, seconds, trace_chunks)
    if log:
        log("set-up " + ", ".join(f"{w} at {t:.2f} s" for w, t in stamps))
        log(f"{win.steps} steps in {win.seconds:.3f} s; regrows by kind "
            f"in the warm-up {kinds}, in the window "
            f"{ {k: v - kinds[k] for k, v in run.sim.regrow_kinds.items()} }"
            f"; temperature at the warm-up's stages' ends {warm} K, in the "
            f"window's first chunk {win.rows[0]['temp']:.1f} K, its last "
            f"{win.rows[-1]['temp']:.1f} K")
    return Driven(system=system, params=params, run=run, win=win,
                  init_s=init_s, setup_s=stamps[-1][1])


def take_case(d: Driven, c: dict):
    """The check's Case of the window's newest chunk that regrew nothing
    (None where every chunk regrew), with the program's state freed."""
    import torch

    from . import check

    case = None
    if d.win.clean is not None:
        case = check.case_of(d.run, c["traffic"], d.system, d.win.clean)
    d.run = d.win = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return case


def execute(c: dict, seed: int, seconds: float, trace: bool, dev) -> tuple:
    """One run of the cell `c` (as `cell` reads it) on `dev`: (result
    line, the numbers compared, their limits, init_state seconds)."""
    import torch

    from . import check, md

    cfg, traffic = c["cfg"], c["traffic"]
    tr_cfg = traffic["trace"]
    d = drive(c, seed, seconds, dev,
              (tr_cfg["skip_chunks"], tr_cfg["chunks"], tr_cfg["gap_chunks"])
              if trace else None,
              log=lambda text: print(f"portbench: {text}", file=sys.stderr))
    win = d.win
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if trace:
        metrics, busy_s, window_s, breakdown = per_layer(c, win, d.run,
                                                         d.system)
    else:
        metrics = {
            "ns_per_day": {"value": md.ns_per_day(
                win.steps, traffic["md"]["dt"], win.seconds),
                "unit": "ns/day"},
            "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": d.setup_s, "unit": "s"}}
    attempted, finite = win.steps, md.finite(win.rows)
    del win
    case = take_case(d, c)
    values = dict.fromkeys(check.NUMBERS, float("nan"))
    if case is not None:
        t_ref = time.perf_counter()
        values, _ = check.readings(cfg, d.params, case, dev)
        print(f"portbench: reference {time.perf_counter() - t_ref:.1f} s "
              f"over {case.steps} steps", file=sys.stderr)
    limits = c["limits"]["limits"]
    correct = finite and check.verdict(values, limits)
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": int(c["workload"]["chips"]),
              "memory_peak_bytes": int(peak)}
    if trace:
        device.update(busy_s=busy_s, window_s=window_s)
    result = {"correct": bool(correct), "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": device}
    if trace:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": values[k], "limit": limits[k]}
                          for k in limits}
    return result, values, limits, d.init_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    c = cell(args.workload)
    cache_dirs()

    import torch

    need = int(c["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA device(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    torch.cuda.reset_peak_memory_stats()
    result, values, limits, init_s = execute(
        c, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    print(f"portbench: {args.workload} seed {args.seed}: {nvidia_smi()}; "
          f"init_state {init_s:.2f} s", file=sys.stderr)
    for k in limits:
        print(f"{k} {values[k]!r} limit {limits[k]!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
