"""The program's spans and host-sync counter (lammps_ani_torch/utils/
profiling.py) on the asn MD path, on the CPU.

WATER30 replicated 3x3x3 (810 atoms, 24 A box), the `pallas_asn` engine
(its kernels' plain versions and the explicit backward), f64, NVE at
small velocities, a rebuild every 12 steps: one 12-step chunk runs to its
end. With recording on: the span tree (`chunk` the parent of `rebuild`,
`step`, `thermo`, `skin_check`, `deficit_check`; `step` of `skin_check`,
`integrate` twice and `forces`; `forces` of `aev_forward`, `nn_forward`
and `grad`, which holds `aev_backward`), the host syncs of a full chunk
by site (17 in the MD loop, 2 in the bins, 3 a step in the potential), a
regrown chunk noted `discarded` with its `regrow` span, and the
parent that a span opened on another thread takes. With recording off:
nothing recorded, no record_function, NVTX range or clock read. Under a
CPU-activity torch.profiler, every span holds Kineto's record of its
record_function, the median end within 50 us of it: the spans and the
trace share one clock.
"""

import collections
import gc
import threading

import numpy as np
import pytest
import torch

import lammps_ani_torch as tlat
from lammps_ani_torch.models import zoo
from lammps_ani_torch.ops import cell_roll as crmod
from lammps_ani_torch.utils import profiling

from . import fixtures

CHUNK = 12
# a full chunk: the rebuild's two reads, a skin check before each step,
# the deficits, the closing displacement and the thermo read-back (17);
# the bins' grid copy and fitting rows' count (2); each step the MLP's
# weight-row index copy for each species present (O and H) and the self
# energies' copy
SITES = {"roll_count": 1, "overflow": 1, "skin_check": CHUNK,
         "deficits": 1, "chunk_disp": 1, "thermo_readback": 1, "bins": 2,
         "mlp_columns": 2 * CHUNK, "self_energies": CHUNK}
CLOCK_US = 50.0
CLOCK_SLACK_US = 5.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions are chains of small tensor operations; one
    OpenMP thread keeps the file's time flat where test processes share
    a machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def start():
    """(sim, state) of the asn engine on the 810-atom water box."""
    rep = 3
    shifts = [np.array([i, j, k]) @ fixtures.WATER30_BOX for i in range(rep)
              for j in range(rep) for k in range(rep)]
    pos = np.concatenate([fixtures.WATER30_POS + s for s in shifts])
    species = np.tile(fixtures.WATER30_SPECIES, rep ** 3)
    vel = 0.002 * np.random.default_rng(3).standard_normal(pos.shape)
    sim = tlat.Simulation(
        potential=zoo.ani2x(num_models=1, dtype=torch.float64, device="cpu",
                            repulsion=True),
        species=species, masses=fixtures.MASSES[species],
        nbr=tlat.NeighborConfig(cutoff=5.1, skin=2.0, k_max=160,
                                ghost_capacity=8192, rebuild_every=CHUNK),
        dt=0.2, dtype=torch.float64, device="cpu", engine="pallas_asn")
    box = tlat.Box(h=torch.tensor(fixtures.WATER30_BOX * rep),
                   origin=torch.tensor(fixtures.WATER30_ORIGIN))
    st = sim.init_state(pos, box, vel=vel)
    assert sim.engine == "pallas_asn"
    return sim, st


@pytest.fixture(scope="module")
def recorded(start):
    """One full chunk with recording on: (Recording, steps done)."""
    sim, st = start
    with profiling.recording() as rec:
        out, rows = sim.run(st, CHUNK, thermo_every=CHUNK)
    return rec, out.step - st.step, rows


def children(rec, index):
    return [s.name for s in rec.spans if s.parent == index]


def test_span_tree_names_and_nesting(recorded):
    rec, steps, rows = recorded
    assert steps == CHUNK and len(rows) == 1
    spans = rec.spans
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns
               for s in spans)
    for s in spans:
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    (chunk,) = [i for i, s in enumerate(spans) if s.name == "chunk"]
    assert spans[chunk].parent is None and spans[chunk].notes is None
    kids = collections.Counter(children(rec, chunk))
    assert kids == {"rebuild": 1, "step": CHUNK, "thermo": CHUNK + 2,
                    "skin_check": 1, "deficit_check": 1}
    steps_ = [i for i, s in enumerate(spans) if s.name == "step"]
    for i in steps_:
        assert children(rec, i) == ["skin_check", "integrate", "forces",
                                    "integrate"]
    forces = [i for i, s in enumerate(spans) if s.name == "forces"]
    assert len(forces) == CHUNK
    for i in forces:
        # the self energies' copy between the MLP and the gradient
        assert children(rec, i) == ["aev_forward", "nn_forward", "sync",
                                    "grad"]
        (grad,) = [j for j, s in enumerate(spans)
                   if s.parent == i and s.name == "grad"]
        assert children(rec, grad) == ["aev_backward"]
    # every sync is a leaf under the span of its read
    parent_of = {"roll_count": "rebuild", "overflow": "rebuild",
                 "skin_check": "skin_check", "deficits": "deficit_check",
                 "chunk_disp": "skin_check", "thermo_readback": "thermo",
                 "bins": "rebuild", "mlp_columns": "nn_forward",
                 "self_energies": "forces"}
    for s in spans:
        if s.name == "sync":
            assert not children(rec, spans.index(s))
            assert spans[s.parent].name == parent_of[s.notes["site"]]


def test_a_full_chunk_counts_its_syncs_by_site(recorded):
    rec, _, _ = recorded
    assert dict(rec.syncs) == SITES
    assert sum(rec.syncs.values()) == 17 + 2 + 3 * CHUNK
    sites = collections.Counter(s.notes["site"] for s in rec.spans
                                if s.name == "sync")
    assert sites == rec.syncs


def test_a_regrown_chunk_is_noted_discarded(start):
    sim0, st0 = start
    sim = tlat.Simulation(
        potential=sim0.potential, species=sim0._species_in,
        masses=fixtures.MASSES[sim0._species_in], nbr=sim0.nbr, dt=sim0.dt,
        dtype=torch.float64, device="cpu", engine="pallas_asn")
    st = sim.init_state(sim0.positions_input_order(st0), st0.box,
                        vel=sim0.velocities_input_order(st0))
    sim._roll_grid = crmod.RollGrid(ncells=sim._roll_grid.ncells, cap=16)
    with profiling.recording() as rec:
        sim.run(st, 2)
    assert sim.regrow_kinds["roll"] == 1
    chunks = [i for i, s in enumerate(rec.spans) if s.name == "chunk"]
    assert len(chunks) == 2
    first, second = (rec.spans[i] for i in chunks)
    assert first.notes == {"discarded": ["roll"]} and second.notes is None
    assert children(rec, chunks[0]) == ["rebuild", "regrow"]
    assert "step" in children(rec, chunks[1])


def test_a_span_on_another_thread_takes_the_recording_threads_parent():
    with profiling.recording() as rec:
        with profiling.phase("grad"):
            def body():
                with profiling.phase("aev_backward"):
                    with profiling.phase("inner"):
                        pass

            t = threading.Thread(target=body)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    names = [s.name for s in rec.spans]
    assert names == ["grad", "aev_backward", "inner"]
    grad, bwd, inner = rec.spans
    assert bwd.parent == 0 and inner.parent == 1
    assert bwd.tid != grad.tid == rec.main_tid and inner.tid == bwd.tid
    with pytest.raises(RuntimeError):
        with profiling.recording():
            with profiling.recording():
                pass


def test_off_records_nothing_and_opens_no_record_function(start,
                                                          monkeypatch):
    sim, st = start
    opened = collections.Counter()

    class Clock:
        @staticmethod
        def time_ns():
            opened["time_ns"] += 1
            raise AssertionError("a clock read while nothing records")

    def counting(name):
        def f(*a, **k):
            opened[name] += 1
            raise AssertionError(f"{name} while nothing records")
        return f

    monkeypatch.setattr(torch.profiler, "record_function",
                        counting("record_function"))
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        counting("range_push"))
    monkeypatch.setattr(profiling, "time", Clock)
    assert profiling.phase("chunk") is profiling.phase("step")
    out, _ = sim.run(st, 3, thermo_every=3)
    assert out.step == st.step + 3 and not opened
    assert profiling._active is None
    x = torch.arange(3.0)
    assert torch.equal(profiling.to_host(x, "skin_check"), x)
    profiling.note(discarded=["roll"])
    assert not opened


def test_spans_share_kinetos_clock(start):
    """Each span holds Kineto's record of its record_function (to
    CLOCK_SLACK_US, the two clocks' conversion), and the median distance
    at either end is within CLOCK_US: the record_function's own cost
    under a CPU-activity profiler, which on a loaded host reaches a few
    hundred microseconds for single spans, is all that parts them. (The
    collector is held off for the run: a collection inside a span would
    lengthen it.)"""
    sim, st = start
    from torch.profiler import ProfilerActivity, profile

    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            # the profiler's first range pays its own set-up
            with torch.profiler.record_function("warm"):
                pass
            with profiling.recording() as rec:
                sim.run(st, 2, thermo_every=2)
    finally:
        gc.enable()
    kineto = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name() != "warm":
            kineto[e.name()].append((e.start_ns(), e.end_ns()))
    mine = collections.defaultdict(list)
    for s in rec.spans:
        mine[s.name].append((s.start_ns, s.end_ns))
    assert set(kineto) == set(mine) >= {"chunk", "step", "forces", "sync",
                                        "aev_backward", "nn_forward"}
    starts, ends = [], []
    for name, spans in mine.items():
        ranges = sorted(kineto[name])
        assert len(ranges) == len(spans), name
        for (s0, s1), (k0, k1) in zip(sorted(spans), ranges):
            starts.append((k0 - s0) / 1e3)
            ends.append((s1 - k1) / 1e3)
    assert min(starts + ends) >= -CLOCK_SLACK_US, min(starts + ends)
    assert np.median(starts) <= CLOCK_US and np.median(ends) <= CLOCK_US, (
        np.median(starts), np.median(ends))
