"""Cells of BENCHMARK.json cut to a size a CPU test run holds."""

from __future__ import annotations

import copy

from portbench import run as runmod


def small_cell(name: str, engine: str = "pallas_asn") -> dict:
    """The cell `name` as `run.cell` reads it, its system cut: the water
    tile x 3^3 (810 atoms), the combustion mixture of 20 CH4 and 40 O2 x
    2^3 (1,440 atoms); one warm-up chunk; `engine` named (the user's path,
    cellroll=True, gives the xla hybrid off the card)."""
    c = copy.deepcopy(runmod.cell(name))
    t = c["traffic"]
    if t["system"]["kind"] == "tile":
        t["system"]["replicate"] = [3, 3, 3]
    else:
        t["system"]["molecules"][0]["count"] = 20
        t["system"]["molecules"][1]["count"] = 40
        t["system"]["replicate"] = [2, 2, 2]
    t["md"]["engine"] = engine
    t["warmup"] = [{"chunks": 1}]
    t["trace"] = {"skip_chunks": 0, "chunks": 1, "gap_chunks": 1}
    return c
