"""The program's spans and host-sync counter on the card: one recorded
chunk of the water tile at 101,250 atoms (WATER30 x 15^3, the water
cell's settings) under `torch.cuda.set_sync_debug_mode("warn")`.

Every synchronizing operation that PyTorch reports is one the counter
counted (none escapes `profiling.to_host`); every kernel's launch record
joins a span inside `chunk`; the device time that the attribution
charges to spans is at least 99% of the pass's busy time.

    python -m pytest portbench/tests -q -m card    # on a machine with a card
"""

import copy
import warnings

import pytest
import torch

from portbench import run as runmod
from portbench import spans, trace
from portbench.counts import work

SYNC = "called a synchronizing CUDA operation"


@pytest.mark.card
def test_one_recorded_chunk_counts_every_sync(card, monkeypatch):
    runmod.cache_dirs()
    c = copy.deepcopy(runmod.cell("water-ani2x-415k-centred"))
    t = c["traffic"]
    t["system"]["replicate"] = [15, 15, 15]
    t["warmup"] = [{"chunks": 2, "damp": 10.0}]
    t["trace"]["chunks"] = 1
    d = runmod.drive(c, 2 ** 31 + 23, 0.0, card)
    assert d.run.sim.engine == "pallas_asn" and d.run.sim.n_atoms == 101250
    sim, caught = d.run.sim, []
    run = sim.run

    def debugged(*args, **kwargs):
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return run(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                caught.extend(str(w.message) for w in ws)

    monkeypatch.setattr(sim, "run", debugged)
    p = spans.record(d.run, t)
    syncs = sum(p.syncs.values())
    reported = sum(SYNC in m for m in caught)
    assert reported == syncs, (reported, p.syncs)
    chunk = t["md"]["rebuild_every"]
    if p.steps == chunk:
        # the MD loop's 5 + a skin check a step, the bins' 2, and a step
        # the MLP's index copy for O and H and the self energies' copy
        assert syncs == 5 + chunk + 2 + 3 * chunk, p.syncs
    idx = spans.Index(p)
    for name, s, e, i in spans.attribute(p):
        if not trace.is_copy(name):
            assert i is not None, name
            assert "chunk" in [x.name for x in idx.chain(i)], name
    out = spans.split(p, work.groups())
    assert out["charged_share"] >= 0.99, out
