"""Profiling: the program's spans and host-sync counter, and trace helpers
(the reference's NVTX surface).

Port of lammps_ani_tpu/utils/profiling.py. The reference labels its phases
with NVTX ranges ("AEV forward", "NN forward", "Force and Stress") and
wraps runs in Nsight; the JAX package names XLA scopes and reads its
profiler's trace. Here:

  * `phase(name)`: the program's span at a layer boundary (the MD path's
    spans: md/simulation.py, models/potential.py, ops/aev_asn.py). Off by
    default, when it returns one shared null context and costs a flag
    check; under a running torch.profiler it opens a
    `torch.profiler.record_function` of that name (a `user_annotation` in
    the trace), recording or not;
  * `recording()`: turns the spans on for its block and yields the
    `Recording` that keeps them in memory: each span's name, start and
    end in `time.time_ns()` (the Unix-epoch nanoseconds in which Kineto
    stamps its events, CUPTI's kernels included, so spans and a
    torch.profiler trace share one clock), thread and parent span; and
    the host syncs counted by site. While it records, every span is also
    an NVTX range of the same name (once CUDA is initialized) for Nsight,
    and a `record_function` under a running torch.profiler:

        from lammps_ani_torch.utils import profiling
        with profiling.recording() as rec:
            state, rows = sim.run(state, 120)
        rec.spans, rec.syncs

  * `sync(site)`: around each operation of the MD path that makes the
    host wait for the device's queue to drain (a read back, a boolean-mask
    index's count, a copy from pageable host memory); while recording,
    counted under `site` and a `sync` span; `to_host(x, site)` is the
    read back, `x.detach().cpu()` inside `sync(site)`;
  * `trace(log_dir)`: `torch.profiler.profile` over CPU and, where a card
    is present, CUDA activities, synchronized at the end and exported as
    a Chrome trace into `log_dir`;
  * `summarize_trace(log_dir)`: the device kernels of the newest trace
    there, summed by kernel name.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import socket
import threading
import time

import torch

TRACE_SUFFIX = ".pt.trace.json.gz"


_NULL = contextlib.nullcontext()
_active = None  # the Recording of the running `recording()` block


class Span:
    """One recorded span: `tid` is its thread's `threading.get_ident()`
    (`Recording.threads` maps it to the thread's native id); `parent`
    is the index in `Recording.spans` of the span it opened in (None at
    the top); `end_ns` is None while it is open; `notes` holds what the
    program marked on it (`note`)."""

    __slots__ = ("name", "start_ns", "end_ns", "tid", "parent", "notes")

    def __init__(self, name, start_ns, tid, parent):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.tid, self.parent, self.notes = tid, parent, None

    def __repr__(self):
        return (f"Span({self.name!r}, {self.start_ns}, {self.end_ns}, "
                f"tid={self.tid}, parent={self.parent}, notes={self.notes})")


class Recording:
    """The spans (in the order they opened) and the host syncs by site of
    one `recording()` block. A span opened on a thread with no span open
    on it (autograd's device thread, which runs the backward on a card)
    takes as parent the innermost span open on the thread that started
    the recording."""

    def __init__(self):
        self.spans: list[Span] = []
        self.syncs: collections.Counter = collections.Counter()
        self.main_tid = threading.get_ident()
        # get_ident() -> get_native_id() of each thread that opened a span
        self.threads: dict[int, int] = {}
        self._stacks: dict[int, list[int]] = {}
        self._lock = threading.Lock()

    def open(self, name: str, start_ns: int) -> int:
        tid = threading.get_ident()
        stack = self._stacks.get(tid)
        if stack is None:
            stack = self._stacks[tid] = []
            self.threads[tid] = threading.get_native_id()
        main = self._stacks.get(self.main_tid)
        parent = stack[-1] if stack else (main[-1] if main else None)
        span = Span(name, start_ns, tid, parent)
        with self._lock:
            index = len(self.spans)
            self.spans.append(span)
        stack.append(index)
        return index

    def close(self, index: int, end_ns: int):
        self.spans[index].end_ns = end_ns
        self._stacks[threading.get_ident()].pop()

    def count(self, site: str):
        with self._lock:
            self.syncs[site] += 1


class _Open:
    """A span of the running recording, with its NVTX range and, under a
    running torch.profiler, its record_function."""

    __slots__ = ("rec", "name", "notes", "index", "rf", "nvtx")

    def __init__(self, rec: Recording, name: str, notes=None):
        self.rec, self.name, self.notes = rec, name, notes

    def __enter__(self):
        # the clock is read outside the record_function (whose own cost
        # under a profiler grows with the events inside it), so a trace's
        # record of it lies within the span, a few microseconds from
        # either end
        start_ns = time.time_ns()
        self.rf = (torch.profiler.record_function(self.name)
                   if torch.autograd._profiler_enabled() else None)
        if self.rf is not None:
            self.rf.__enter__()
        self.nvtx = torch.cuda.is_initialized()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.index = self.rec.open(self.name, start_ns)
        span = self.rec.spans[self.index]
        span.notes = self.notes
        return span

    def __exit__(self, *exc):
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec.close(self.index, time.time_ns())
        return False


def phase(name: str):
    """The span `name` (module docstring): a null context unless a
    recording or a torch.profiler runs."""
    rec = _active
    if rec is not None:
        return _Open(rec, name)
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def note(**notes):
    """Mark the innermost span open on this thread (while recording)."""
    rec = _active
    if rec is None:
        return
    stack = rec._stacks.get(threading.get_ident())
    if stack:
        span = rec.spans[stack[-1]]
        span.notes = {**(span.notes or {}), **notes}


def sync(site: str):
    """Around one operation that makes the host wait for the device (a
    read back, a boolean-mask index's count, a copy from pageable host
    memory): while recording, one host sync counted under `site` and a
    `sync` span noted with the site; else a null context."""
    rec = _active
    if rec is None:
        return _NULL
    rec.count(site)
    return _Open(rec, "sync", {"site": site})


def to_host(x: torch.Tensor, site: str) -> torch.Tensor:
    """`x` on the host (`x.detach().cpu()`), one `sync` at `site`."""
    with sync(site):
        return x.detach().cpu()


@contextlib.contextmanager
def recording():
    """Record the program's spans and host syncs in the block; yields the
    `Recording`, which keeps them after the block ends. Recordings do not
    nest."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already running")
    rec = Recording()
    _active = rec
    try:
        yield rec
    finally:
        _active = None


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body; the trace lands in `log_dir` as
    `<host>_<pid>.<ns>.pt.trace.json.gz`. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(str(log_dir), name + TRACE_SUFFIX))


def read_trace(path) -> dict:
    """A Chrome trace as `trace` writes it (gzip or plain JSON)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as fh:
        return json.load(fh)


def kernel_events(tr: dict):
    """The device kernels' complete events of a trace."""
    return [e for e in tr.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") == "kernel"
            and "dur" in e]


def summarize_trace(log_dir: str, top: int | None = 25):
    """[(total_ms, kernel name)] of the device kernels in the newest trace
    under `log_dir`, largest first (`top` None: every kernel)."""
    files = glob.glob(os.path.join(str(log_dir), "*.pt.trace.json*"))
    if not files:
        raise FileNotFoundError(f"no trace under {log_dir}")
    by = collections.Counter()
    for e in kernel_events(read_trace(max(
            files, key=lambda f: (os.path.getmtime(f), f)))):
        by[e["name"]] += e["dur"]
    return [(dur / 1e3, name) for name, dur in by.most_common(top)]
