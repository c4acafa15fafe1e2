"""Profiling annotations and helpers (the reference's NVTX surface).

Port of lammps_ani_tpu/utils/profiling.py. The reference labels its phases
with NVTX ranges ("AEV forward", "NN forward", "Force and Stress") and
wraps runs in Nsight; the JAX package names XLA scopes and reads its
profiler's trace. Here:

  * `phase(name)`: a `torch.profiler.record_function` range (a
    `user_annotation` in a trace) and, once CUDA is initialized, an NVTX
    range of the same name; the engines label the MLP "nn_forward";
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
import time

import torch

TRACE_SUFFIX = ".pt.trace.json.gz"


@contextlib.contextmanager
def phase(name: str):
    nvtx = torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


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
