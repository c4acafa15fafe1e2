"""Bounds and counted FLOPs from the frozen tables and the counted work.

A kernel's bound is the larger of its least bytes over the HBM peak and
its operations' time (the larger of fp32 instructions at their rate and
special-function results at theirs, or operations at the fma rate), per
step or per rebuild as its table says. The step's counted FLOPs are the
asn tables' fp32 instructions (one FLOP each: an fma would count 2, so
this undercounts) and the MLP's products forward and for the input
gradient, 2 FLOPs a multiply-add, over the columns of the species present
and the published hidden widths.
"""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load(config_name: str) -> dict:
    """asn_kernels.json with the configuration's own rows over it."""
    with open(os.path.join(HERE, "asn_kernels.json")) as fh:
        tables = json.load(fh)
    own = os.path.join(HERE, f"asn_kernels.{config_name}.json")
    if os.path.exists(own):
        with open(own) as fh:
            for name, rows in json.load(fh)["kernels"].items():
                tables["kernels"][name] = {**tables["kernels"][name], **rows}
    return tables


def groups() -> list:
    with open(os.path.join(HERE, "groups.json")) as fh:
        return json.load(fh)["groups"]


def kernel_bound_s(tables: dict, name: str, work: dict) -> float:
    """Seconds one launch set (a step's or a rebuild's) of `name` needs
    at least."""
    k, peaks = tables["kernels"][name], tables["peaks"]
    t_bytes = sum(b * work[u] for u, b in k.get("bytes", {}).items()) \
        / peaks["bytes_per_s"]
    instr = k.get("instr", {})
    t_instr = sum(v[0] * work[u] for u, v in instr.items()) / peaks[
        "f32_instr"]
    t_sfu = sum(v[1] * work[u] for u, v in instr.items()) / peaks["sfu"]
    t_fma = sum(v * work[u] for u, v in k.get("fma", {}).items()) / peaks[
        "f32_flops"]
    return max(t_bytes, t_instr, t_sfu, t_fma)


def asn_bound_s(tables: dict, work: dict, steps: int, rebuilds: int) -> dict:
    """{kernel: seconds at least} over `steps` steps and `rebuilds`
    rebuilds."""
    return {name: kernel_bound_s(tables, name, work)
            * (rebuilds if k["per"] == "rebuild" else steps)
            for name, k in tables["kernels"].items()}


def mlp_flops(cfg: dict, work: dict) -> float:
    """FLOPs of one force evaluation's networks: 2 a multiply-add, forward
    and the input gradient, every model, over the present columns."""
    n_in = (work["rad_col"] + work["ang_col"]) / max(work["atom"], 1)
    macs = 0.0
    for s, count in enumerate(work["species_atoms"]):
        dims = (n_in, *cfg["hidden"][s], 1)
        macs += count * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return 4.0 * macs * int(cfg["num_models"])


def step_flops(cfg: dict, tables: dict, work: dict, steps: int,
               rebuilds: int) -> float:
    """Counted FLOPs of `steps` steps and `rebuilds` rebuilds."""
    instr = 0.0
    for name, k in tables["kernels"].items():
        per = rebuilds if k["per"] == "rebuild" else steps
        instr += per * sum(v[0] * work[u] for u, v in k.get("instr",
                                                              {}).items())
        instr += per * sum(v * work[u] for u, v in k.get("fma", {}).items())
    return instr + steps * mlp_flops(cfg, work)
