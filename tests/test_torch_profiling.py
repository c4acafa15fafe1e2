"""The port's profiling helpers (lammps_ani_torch/utils/profiling.py) on
the CPU: `phase` labels appear in a `trace` of a small force evaluation
of the port, "nn_forward" among them (the MLP's label at the engines'
three sites); `summarize_trace` sums the device kernels of the newest
trace by name, largest first (a written trace in torch's Chrome format,
gzip and plain; the CPU trace has none); a directory without a trace
raises FileNotFoundError, as the JAX helper does.
"""

import gzip
import json
import os
import time

import numpy as np
import pytest
import torch

import lammps_ani_torch as tlat
from lammps_ani_torch.models import zoo
from lammps_ani_torch.utils import profiling

from . import fixtures


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def annotations(log_dir):
    (path,) = [p for p in os.listdir(log_dir) if ".pt.trace.json" in p]
    tr = profiling.read_trace(os.path.join(log_dir, path))
    return [e["name"] for e in tr["traceEvents"]
            if e.get("cat") == "user_annotation"]


def test_phase_labels_in_a_trace(tmp_path):
    species = fixtures.WATER30_SPECIES
    sim = tlat.Simulation(
        potential=zoo.ani2x(num_models=1, device="cpu", repulsion=True),
        species=species, masses=fixtures.MASSES[species],
        nbr=tlat.NeighborConfig(cutoff=5.1, k_max=128, ghost_capacity=1024),
        device="cpu")
    box = tlat.Box.from_lammps(-4.0, 4.0, -4.0, 4.0, -4.0, 4.0,
                               device="cpu")
    with profiling.trace(tmp_path):
        with profiling.phase("init_state"):
            st = sim.init_state(fixtures.WATER30_POS, box)
    names = annotations(tmp_path)
    assert "init_state" in names and "nn_forward" in names
    assert bool(torch.isfinite(st.force).all())
    assert isinstance(profiling.summarize_trace(tmp_path), list)


def write_trace(path, events):
    tr = {"traceEvents": [
        {"ph": "X", "cat": cat, "name": name, "ts": 10.0 * k, "dur": dur}
        for k, (cat, name, dur) in enumerate(events)]}
    data = json.dumps(tr).encode()
    if path.endswith(".gz"):
        data = gzip.compress(data)
    with open(path, "wb") as fh:
        fh.write(data)


def test_summarize_trace_sums_kernels_by_name(tmp_path):
    old = str(tmp_path / "a_1.1.pt.trace.json")
    write_trace(old, [("kernel", "stale", 5000.0)])
    time.sleep(0.01)
    new = str(tmp_path / "a_1.2.pt.trace.json.gz")
    write_trace(new, [("kernel", "gemm", 1500.0), ("kernel", "fold", 250.0),
                      ("kernel", "gemm", 700.0), ("cpu_op", "aten::mm", 9e4),
                      ("kernel", "asn_wing_kernel", 900.0),
                      ("gpu_memcpy", "Memcpy HtoD", 3e3)])
    os.utime(old, (1.0, 1.0))
    got = profiling.summarize_trace(tmp_path)
    assert got == [(2.2, "gemm"), (0.9, "asn_wing_kernel"), (0.25, "fold")]
    ms = [m for m, _ in got]
    assert ms == sorted(ms, reverse=True)
    assert profiling.summarize_trace(tmp_path, top=1) == [(2.2, "gemm")]
    assert sum(m for m, _ in profiling.summarize_trace(tmp_path, top=None)
               ) == pytest.approx(3.35)
    assert np.isclose(sum(e["dur"] for e in profiling.kernel_events(
        profiling.read_trace(new))) / 1e3, 3.35)


def test_summarize_trace_without_a_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(tmp_path)
