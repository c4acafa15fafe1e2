"""The program's spans on the device trace's clock: the recorded pass of a
traced run and the attribution of its device time to program layers.

The program records its spans and host syncs while
`lammps_ani_torch.utils.profiling.recording()` runs (a span: name, start
and end in `time.time_ns()`, thread, parent; a sync: an operation that
makes the host wait for the device, by site, inside a `sync` span).
Kineto stamps its events, CUPTI's kernels and the CUDA runtime's launch
records included, in the same Unix-epoch nanoseconds, so the two are
joined with no offset to fit:

  * `record(run, traffic)`: `trace.chunks` more chunks of the traffic
    from the run's state, the recorder on, under torch.profiler with the
    device's activity alone (whose CUDA activity set carries the runtime's
    launch records: name, start, thread, correlation id); None where the
    program has no recorder or the device no trace;
  * the attribution: each kernel or copy is joined by correlation id to
    its launch, and the launch to the innermost span open at that time on
    the launching thread, or, where none is, on the thread that started
    the recording (autograd's device thread runs `_AsnFused.backward` and
    the MLP's backward while that thread waits inside `grad`);
  * a span's layer is the layer of the innermost span on its chain that
    `LAYERS` names (`sync` and the structural spans `chunk`, `step`,
    `forces`, `regrow` name none);
  * the idle gaps: the gaps in the union of the device's busy intervals
    over the pass's window on the host's clock.

The per-layer readers (`portbench/metrics/<name>.py`) take the pass from
`of(ctx)`. The harness's `Context` carries no simulation, so the first
reader runs the pass with the `Run` and the cell found among its callers'
locals (`run.per_layer`'s), after the readers of the accepted metrics,
and keeps it on the context for the others.

    python -m portbench.spans --workload <cell> --seed <n> [--turns 3]

runs a cell's set-up and a short window, then the recorded pass with the
recorder on and off in turns (under the profiler and without it): the
recorder's cost in ms a step, and the recorded pass's split of the
device's time and idle gaps by span, one JSON line each.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import sys
import time

from . import trace as trmod

# span name -> layer; the readers sum the device time by layer
LAYERS = {"rebuild": "rebuild",
          "integrate": "integrate", "thermo": "integrate",
          "skin_check": "integrate", "deficit_check": "integrate",
          "aev_forward": "aev", "aev_backward": "aev",
          "nn_forward": "mlp", "grad": "mlp"}
OUTSIDE = "(outside the program)"
LAUNCH_PREFIX = "cu"  # cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel, ...


@dataclasses.dataclass
class Pass:
    """The recorded pass: Kineto's events and the program's recording."""

    device: list  # [(name, start_ns, end_ns, correlation)] kernels, copies
    launches: dict  # correlation -> (start_ns, thread) runtime records
    spans: list  # [profiling.Span] in the order they opened
    main_tid: int  # the thread that started the recording
    threads: dict  # a span's tid -> the thread's native id
    syncs: dict  # site -> host syncs counted
    steps: int  # MD steps the pass took
    window_ns: tuple  # (start, end) on the host's clock


def _tid32(tid) -> int:
    """A thread identifier's low 32 bits: a launch record's thread is the
    thread's pthread identifier (`threading.get_ident()`) so truncated
    where Kineto leaves CUPTI's thread ids as they are, as in a CUDA-only
    trace, and its native id where it maps them, as after a trace that
    recorded the host's operations."""
    return int(tid) & 0xFFFFFFFF


class Index:
    """The innermost span open at a time, per thread."""

    def __init__(self, p: Pass):
        self.p = p
        by = collections.defaultdict(list)
        for i, s in enumerate(p.spans):
            by[_tid32(s.tid)].append(i)
        self.by_thread = {t: (ix, [p.spans[i].start_ns for i in ix])
                          for t, ix in by.items()}
        self.main = _tid32(p.main_tid)
        self.alias = {_tid32(native): _tid32(tid)
                      for tid, native in p.threads.items()}

    def on_thread(self, tid32: int, t: float):
        """Index of the innermost span open at `t` on the thread, or
        None."""
        ix, starts = self.by_thread.get(tid32, ((), ()))
        k = bisect.bisect_right(starts, t) - 1
        if k < 0:
            return None
        i = ix[k]
        spans = self.p.spans
        while i is not None:
            s = spans[i]
            if _tid32(s.tid) != tid32:
                return None
            if s.start_ns <= t <= s.end_ns:
                return i
            i = s.parent
        return None

    def at_launch(self, t: float, tid) -> object:
        """The launch's span: on its own thread first, else on the thread
        that started the recording."""
        i = None
        if tid is not None:
            t32 = _tid32(tid)
            i = self.on_thread(self.alias.get(t32, t32), t)
        return self.on_thread(self.main, t) if i is None else i

    def chain(self, i):
        spans = self.p.spans
        while i is not None:
            yield spans[i]
            i = spans[i].parent

    def layer(self, i):
        for s in self.chain(i):
            if s.name in LAYERS:
                return LAYERS[s.name]
        return None


def attribute(p: Pass) -> list:
    """[(name, start_ns, end_ns, span index or None)] of the device's
    events, each at the span of its launch (None: no launch record, or a
    launch outside every span)."""
    idx = Index(p)
    out = []
    for name, s, e, corr in p.device:
        launch = p.launches.get(corr)
        i = None if launch is None else idx.at_launch(*launch)
        out.append((name, s, e, i))
    return out


def device_ns_by_layer(p: Pass, groups) -> dict:
    """{layer: {name group: ns}} (counts/groups.json's groups and "glue");
    the layer None holds what no layer span launched."""
    idx = Index(p)
    out = collections.defaultdict(lambda: collections.defaultdict(float))
    for name, s, e, i in attribute(p):
        layer = None if i is None else idx.layer(i)
        out[layer][trmod.group_of(name, groups)] += e - s
    return out


def gaps(p: Pass) -> list:
    """[(start_ns, end_ns)]: the device's idle gaps over the window."""
    lo, hi = p.window_ns
    out, at = [], lo
    for s, e in trmod.union((d[1], d[2]) for d in p.device):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def sync_idle_ns(p: Pass) -> float:
    """Idle ns in gaps that open while the host is inside a `sync` span:
    the queue drained because the host waited, until the next kernel or
    copy starts."""
    waits = sorted((s.start_ns, s.end_ns) for s in p.spans
                   if s.name == "sync")
    starts = [w[0] for w in waits]
    total = 0.0
    for g0, g1 in gaps(p):
        k = bisect.bisect_right(starts, g0) - 1
        if k >= 0 and waits[k][1] >= g0:
            total += g1 - g0
    return total


def idle_gaps_by_span(p: Pass) -> dict:
    """{span name: idle ns}: each gap charged to the innermost span open
    on the recording's thread at its midpoint (OUTSIDE where none is)."""
    idx = Index(p)
    out = collections.defaultdict(float)
    for g0, g1 in gaps(p):
        i = idx.on_thread(idx.main, 0.5 * (g0 + g1))
        out[OUTSIDE if i is None else p.spans[i].name] += g1 - g0
    return dict(out)


def ms_per_step(p, ns: float):
    return ns * 1e-6 / p.steps if p is not None and p.steps else None


# ---------- the pass on the card ----------


def _chunks(run, traffic):
    md = traffic["md"]
    st = run.state
    for _ in range(traffic["trace"]["chunks"]):
        st, _ = run.sim.run(st, md["rebuild_every"],
                            thermo_every=md["thermo_every"])
    return st


def _recorder(on: bool):
    """The program's recording, or (off) an empty Recording."""
    from lammps_ani_torch.utils import profiling

    return (profiling.recording() if on
            else contextlib.nullcontext(profiling.Recording()))


def record(run, traffic, recording: bool = True):
    """The recorded pass (module docstring) from `run.state`, which it
    leaves as it was; None where the program has no recorder or the run
    no card. `recording=False` runs the same pass with the recorder off
    (its cost, `main`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lammps_ani_torch.utils import profiling

    dev = run.sim.device
    if (not hasattr(profiling, "recording")
            or torch.device(dev).type != "cuda"):
        return None
    torch.cuda.synchronize(dev)
    step0 = run.state.step
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            _recorder(recording) as rec:
        t0 = time.time_ns()
        st = _chunks(run, traffic)
        torch.cuda.synchronize(dev)
        t1 = time.time_ns()
    labels = {s.name for s in rec.spans}
    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation() and e.name() not in labels:
                device.append((e.name(), e.start_ns(), e.end_ns(),
                               e.correlation_id()))
        elif e.name().startswith(LAUNCH_PREFIX) and e.correlation_id():
            launches[e.correlation_id()] = (e.start_ns(),
                                            e.device_resource_id())
    corrs = {d[3] for d in device}
    return Pass(device=device,
                launches={c: v for c, v in launches.items() if c in corrs},
                spans=rec.spans, main_tid=rec.main_tid,
                threads=dict(rec.threads), syncs=dict(rec.syncs),
                steps=st.step - step0, window_ns=(t0, t1))


def _harness():
    """(md.Run, cell) from the locals of the reader's callers, or None."""
    from . import md

    f = sys._getframe(1)
    while f is not None:
        vals = list(f.f_locals.values())
        runs = [v for v in vals if isinstance(v, md.Run)]
        cells = [v for v in vals if isinstance(v, dict)
                 and "traffic" in v and "workload" in v]
        if runs and cells:
            return runs[0], cells[0]
        f = f.f_back
    return None


def of(ctx):
    """The context's recorded pass (run once, kept on the context as
    `recorded`), or None where there is none to record."""
    if not hasattr(ctx, "recorded"):
        found = _harness()
        ctx.recorded = None if found is None else record(
            found[0], found[1]["traffic"])
    p = ctx.recorded
    return p if p is not None and p.steps and p.device else None


# ---------- the recorder's cost and the split, on the card ----------


def _timed(run, traffic, recording: bool) -> float:
    """ms a step of the pass, recorder on or off, with no profiler."""
    import torch

    dev = run.sim.device
    torch.cuda.synchronize(dev)
    step0 = run.state.step
    t0 = time.perf_counter()
    with _recorder(recording):
        st = _chunks(run, traffic)
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / (st.step - step0)


def split(p: Pass, groups) -> dict:
    """The recorded pass's readings: the six metrics, the glue by name,
    the device time and idle by span, the largest glue kernels under each
    layer's span, the launches outside a chunk."""
    by = device_ns_by_layer(p, groups)
    glue = trmod.device_us_by_group(
        trmod.Trace(device=[(n, s, e) for n, s, e, _ in p.device], host=[],
                    window_us=0.0), groups)["glue"]
    idx = Index(p)
    att = attribute(p)
    by_span = collections.defaultdict(float)
    glue_kernels = collections.defaultdict(collections.Counter)
    outside_chunk, charged = 0, []
    for name, s, e, i in att:
        names = [x.name for x in idx.chain(i)] if i is not None else []
        if "chunk" not in names:
            outside_chunk += 1
        else:
            charged.append((s, e))
        by_span[names[0] if names else OUTSIDE] += e - s
        if trmod.group_of(name, groups) == "glue":
            owner = next((n for n in names if n in LAYERS),
                         names[0] if names else OUTSIDE)
            glue_kernels[owner][name[:100]] += e - s
    busy = sum(e - s for s, e in trmod.union((d[1], d[2])
                                             for d in p.device))

    def ms(ns):
        return ms_per_step(p, ns)

    return {
        "steps": p.steps, "syncs": p.syncs,
        "host_syncs_per_step": sum(p.syncs.values()) / p.steps,
        "sync_idle_ms_per_step": ms(sync_idle_ns(p)),
        "rebuild_ms_per_step": ms(sum(by["rebuild"].values())),
        "integrate_ms_per_step": ms(sum(by["integrate"].values())),
        "aev_glue_ms_per_step": ms(by["aev"]["glue"]),
        "mlp_glue_ms_per_step": ms(by["mlp"]["glue"]),
        "glue_by_name_ms_per_step": ms(glue),
        "glue_by_layer_ms_per_step": {str(k): ms(v["glue"])
                                      for k, v in by.items()},
        "device_ms_by_layer": {str(k): {g: ms(x) for g, x in v.items()}
                               for k, v in by.items()},
        "device_ms_by_span": {k: ms(v) for k, v in sorted(
            by_span.items(), key=lambda kv: -kv[1])},
        "glue_kernels_ms_by_span": {
            k: [[n, ms(v)] for n, v in c.most_common(6)]
            for k, c in glue_kernels.items()},
        "idle_ms_by_span": {k: ms(v) for k, v in sorted(
            idle_gaps_by_span(p).items(), key=lambda kv: -kv[1])},
        "window_ms_per_step": ms(p.window_ns[1] - p.window_ns[0]),
        "busy_ms_per_step": ms(busy),
        "charged_share": sum(e - s for s, e in trmod.union(charged))
        / busy if busy else None,
        "events_outside_chunk": outside_chunk, "events": len(att),
        "launch_records": len(p.launches)}


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from . import run as runmod
    from .counts import work as workmod

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args(argv)
    c = runmod.cell(args.workload)
    runmod.cache_dirs()
    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    d = runmod.drive(c, args.seed, args.seconds, dev)
    traffic, groups = c["traffic"], workmod.groups()
    card = runmod.nvidia_smi()
    record(d.run, traffic)  # the profiler's own first start
    for turn in range(args.turns):
        for on in (True, False):
            t0 = time.perf_counter()
            p = record(d.run, traffic, recording=on)
            wall = (time.perf_counter() - t0) * 1e3 / p.steps
            line = {"workload": args.workload, "seed": args.seed,
                    "card": card, "turn": turn, "recording": on,
                    "profiled": True,
                    "window_ms_per_step": ms_per_step(
                        p, p.window_ns[1] - p.window_ns[0]),
                    "call_ms_per_step": wall}
            if on:
                line.update(split(p, groups))
            print(json.dumps(line), flush=True)
        for on in (True, False):
            print(json.dumps({"workload": args.workload, "card": card,
                              "turn": turn, "recording": on,
                              "profiled": False, "ms_per_step": _timed(
                                  d.run, traffic, on)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
