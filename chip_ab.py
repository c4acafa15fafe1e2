"""Time named asn and roll kernels of the checkout in the working
directory, on one CUDA card, and count the SASS lines nvcc emitted for
them.

Two builds of one kernel can be told apart only inside one process sequence
on one card: run this script once per checkout, in turns, from one shell
command, with each checkout's root as the working directory:

    for t in parent change change parent; do
        (cd $t && python3 /path/to/chip_ab.py $t step_fused radial_gamma)
    done

It imports `chip_smoke` and `lammps_ani_torch` from the working directory
(not from beside this file), builds that checkout's kernels, and prints
one JSON line. An asn name (a key of chip_smoke's `asn_calls` in that
checkout) is timed on the 101,250-atom water box of chip_smoke's main path
at its first rebuild (f32, ANI-2x + XTB repulsion, the sizing `Simulation`
derives); a roll name (radial_fwd, radial_bwd, angular_fwd, angular_bwd:
chip_smoke's `kernel_calls`) on the same tile under the roll engine
(pallas_full, no repulsion, f32) at its first rebuild, with chip_smoke's
seeded cotangents; a per-block backward (block_bwd, block_bwd_tri) is
one force evaluation's launches of it (chip_smoke's `stage_launches` under
pair_stage "blocks", seeded cotangents) on the same tile under the asn
engine with pair_stage "blocks" at its first rebuild, adding into buffers
that the timed calls keep (the digest's call adds into zeros); a per-block
forward (block_fwd, block_fwd_tri) is one force evaluation's launches of
it on the same rows. Each timed
name gets three rounds of 20 calls by CUDA events (ms per call; a packed
kernel's call launches it once per occupancy tier, a per-block one once
per block and tier, and the line gives the launches per call). Each f32
kernel function whose name carries one of the names (`asn_<name>_kernel`
in csrc/aev_asn.cu, `<name>_kernel` in csrc/aev_roll.cu) gets the count of
its SASS lines and of a few kinds of operation among them (`cuobjdump
-sass`; LDL and STL are local-memory loads and stores). A name without a
call gets the counts only. Each call is the
checkout's own wrapper on the same tensors: `wing` is `wing(gt, inv, idx)`
where the wrapper takes idx (the kernel scatters over idx) and
`wing(gt, inv)` in a checkout whose kernel gathers through inv. Each
timed name also gets a digest of its first call's outputs (sha256 of their
bytes), so two checkouts whose kernels give the same bits show the same
digest.

A probe name, `probe_compact:<mode>` (a mode of the checkout's
probes.micro_gather: affine, gather1, gather3, decompact, onehot) or
`probe_radial_variant:<stage>` (a stage of probes.micro_kernel_variants),
needs no water box: the compact mode is timed at each of micro_gather's
CASES (one key per case, `probe_compact:<mode>[n_tiles, cap, W, K]`),
the variant stage at micro_kernel_variants.MAIN, on the inputs those
modules make from seed 0, through the checkout's own wrapper (three
rounds of 20 calls, a digest of the first call's output). Any probe
name also gets the SASS counts of every kernel of csrc/probes.cu, keyed
`probe:<kernel>[<template argument>]`, by opcode (the same kinds, and
the shared loads and stores, cp.async copies, fused multiply-adds and
the float compares FSET, FSETP and FSEL).

The README's port section shows how to run it on the card against the
parent commit.
"""

import hashlib
import json
import os
import subprocess
import sys

import torch

KINDS = ("LDL", "STL", "LDG", "STG", "MUFU", "SHFL", "BRA")
PROBE_KINDS = KINDS + ("LDS", "STS", "LDGSTS", "FFMA", "FSET", "FSETP",
                       "FSEL")
BLOCK = ("block_fwd", "block_fwd_tri", "block_bwd", "block_bwd_tri")
PROBES = ("probe_compact", "probe_radial_variant")


def sass_counts(names):
    """{function: {"n": SASS lines, kind: count}} of the f32 kernels of
    the freshly built aev_asn and aev_roll libraries that carry one of
    `names` (`asn_<name>_kernel`, `<name>_kernel`)."""
    from lammps_ani_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = {}
    for source, prefix in (("aev_asn.cu", "asn_"), ("aev_roll.cu", "")):
        lib = str(_build._target(source))
        sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        cur = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                hit = [n for n in names if f"{prefix}{n}_kernelIf" in fn]
                cur = hit[0] if hit else None
                if cur:
                    # a kernel with more template arguments than its type
                    # (radial_bwd's plane form Lb1 and row form Lb0) under
                    # a key each
                    more = fn.split(f"{prefix}{cur}_kernelIf")[1]
                    more = more[:more.find("EE")] if more[:1] == "L" else ""
                    cur = f"{cur}[{more}]" if more else cur
                    out[cur] = dict.fromkeys(("n",) + KINDS, 0)
            elif cur and "/*" in line and ";" in line:
                out[cur]["n"] += 1
                for kind in KINDS:
                    if f" {kind}" in line or f"{kind}." in line:
                        out[cur][kind] += 1
    return out


def probe_sass_counts():
    """{"probe:<kernel>[<template argument>]": {"n": SASS lines, kind:
    count}} of every kernel of the freshly built probes library, by the
    opcode of each instruction (its predicate and modifiers dropped)."""
    import re

    from lammps_ani_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build._target("probes.cu"))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(probe_\w+?_kernel)(?:ILi(\d+)E)?",
                          line.split("Function :")[1])
            cur = (f"probe:{m[1]}" + (f"[{m[2]}]" if m[2] else "")
                   if m else None)
            if cur:
                out[cur] = dict.fromkeys(("n",) + PROBE_KINDS, 0)
        elif cur and "/*" in line and ";" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if not words:
                continue
            out[cur]["n"] += 1
            op = words[0].split(".")[0]
            if op in out[cur]:
                out[cur][op] += 1
    return out


def probe_calls(names):
    """{key: (timed call, launch counts)} of the probe names: a compact
    mode once per micro_gather case, a variant stage at
    micro_kernel_variants.MAIN, through the checkout's wrappers on the
    inputs its modules make from seed 0."""
    from lammps_ani_torch.probes import micro_gather as pmg
    from lammps_ani_torch.probes import micro_kernel_variants as pmv

    calls = {}
    modes = [n.split(":")[1] for n in names
             if n.startswith("probe_compact:")]
    if modes:
        for case in pmg.CASES:
            inp = pmg.make_inputs(*case, seed=0, device="cuda")
            for mode in modes:
                x, idx = pmg._operands(mode, inp)
                calls[f"probe_compact:{mode}{list(case)}"] = (
                    lambda mode=mode, x=x, idx=idx, k=inp["k"]:
                    pmg.compact(mode, x, idx, k), pmg.LAUNCHES, mode)
    stages = [n.split(":")[1] for n in names
              if n.startswith("probe_radial_variant:")]
    if stages:
        args = pmv.make_inputs(**pmv.MAIN, seed=0, device="cuda")
        for st in stages:
            calls[f"probe_radial_variant:{st}"] = (
                lambda st=st: pmv.radial_variant(st, *args), pmv.LAUNCHES,
                st)
    return calls


def digest(out) -> str:
    """sha256 (16 hex digits) of the bytes of a call's output tensors."""
    h = hashlib.sha256()
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        if isinstance(t, torch.Tensor):
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def block_calls(c, data):
    """{name: (timed call, the digest's call)} of the per-block kernels:
    one force evaluation's launches under pair_stage "blocks" at the first
    rebuild of the asn engine sized for that stage. A backward's timed call
    adds into buffers it keeps, the digest's into zeros; a forward's two
    calls are one."""
    sim = c.make_sim(data, torch.float32, "cuda", pair_stage="blocks")
    box = c.make_box(data, torch.float32, "cuda")
    state = sim.init_state(data.positions, box)
    k = c.asn_inputs(sim, state.pos, box)
    part = k["part"]
    tiers = part["tiers"] or ((sim.potential.spec.angular_caps, None),)
    rows = [(cat_t, caps_t, k["a_offs"])
            for (caps_t, _), cat_t in zip(tiers, part["cats"])]
    aev = sim.potential.spec.aev
    launches = c.stage_launches(aev, rows, "blocks")
    out = {}
    for name in BLOCK:
        lau = launches[name]
        if name.startswith("block_fwd"):
            call = (lambda lau=lau, name=name: c.block_call(name, aev, lau))
            out[name] = (call, call)
            continue
        accs = [torch.zeros_like(cat) for cat, _, _ in lau]
        out[name] = (lambda lau=lau, accs=accs, name=name:
                     c.block_call(name, aev, lau, accs=accs),
                     lambda lau=lau, name=name: c.block_call(name, aev, lau))
    return out


def main(argv):
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())  # this checkout, not this file's
    import chip_smoke as c

    tag, names = argv[1], argv[2:]
    c._build.build_all()
    probes = [name for name in names if name.split(":")[0] in PROBES]
    names = [name for name in names if name not in probes]
    data = c.water_box(15) if names else None
    calls, counts = {}, {}
    if any(name not in c.KERNELS + BLOCK for name in names):
        sim = c.make_sim(data, torch.float32, "cuda")
        box = c.make_box(data, torch.float32, "cuda")
        state = sim.init_state(data.positions, box)
        calls.update(c.asn_calls(c.asn_inputs(sim, state.pos, box)))
        counts.update(dict.fromkeys(calls, c.asn.LAUNCHES))
    if any(name in c.KERNELS for name in names):
        sim = c.make_sim(data, torch.float32, "cuda", engine="pallas_full")
        state = sim.init_state(data.positions,
                               c.make_box(data, torch.float32, "cuda"))
        roll = c.kernel_calls(c.kernel_inputs(sim, state))
        calls.update(roll)
        counts.update(dict.fromkeys(roll, c.ar.LAUNCHES))
    first = {}  # a call for the digest where it is not the timed one
    if any(name in BLOCK for name in names):
        blocks = block_calls(c, data)
        calls.update(blocks)
        first.update({name: fns[1] for name, fns in blocks.items()})
        counts.update(dict.fromkeys(blocks, c.asn.LAUNCHES))
    timed = [name for name in names if name in calls]
    launches, digests = {}, {}
    for name in timed:
        c.asn.reset_counts()
        c.ar.reset_counts()
        digests[name] = digest(first.get(name, calls[name][0])())
        launches[name] = counts[name][name]
    ms = {name: [c.time_ms(calls[name][0], reps=20, warm=2) for _ in range(3)]
          for name in timed}
    sass = sass_counts(names) if names else {}
    for key, (call, count, label) in probe_calls(probes).items():
        c._reset_all_counts()
        digests[key] = digest(call())
        launches[key] = count[label]
        ms[key] = [c.time_ms(call, reps=20, warm=2) for _ in range(3)]
        torch.cuda.synchronize()
    if probes:
        sass.update(probe_sass_counts())
    print(json.dumps({"tree": tag, "card": c.nvidia_smi_line(),
                      "atoms": data.n_atoms if data else None, "ms": ms,
                      "launches_per_call": launches, "digest": digests,
                      "sass": sass}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
