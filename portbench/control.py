"""The check's two readings at a cell's own size, on the card.

    python -m portbench.control --workload <cell> --seconds 3 \
        --seeds 11 12 13

For each seed, in one process: the cell's set-up and a short window of
the program, then, of the window's chunk that the check takes, the
numbers compared (portbench/check.py) for the program and for the
control: the reference in f32 with TF32 products (the precision below
the configuration's f32 with TF32 off) put in the program's place, each
against the f64 reference. One JSON line a seed; the limits in
`portbench/limits/<cell>.json` are set from these readings: above the
program's largest, below the control's smallest.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch


def main(argv=None) -> int:
    from . import check, run as runmod

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    c = runmod.cell(args.workload)
    runmod.cache_dirs()
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        d = runmod.drive(c, seed, args.seconds, dev, log=lambda text: print(
            f"portbench.control: seed {seed}: {text}", file=sys.stderr,
            flush=True))
        case = runmod.take_case(d, c)
        t0 = time.perf_counter()
        got, ctl = check.readings(c["cfg"], d.params, case, dev,
                                  control=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "steps": case.steps,
            "seconds": time.perf_counter() - t0, "program": got,
            "control": ctl, "device": torch.cuda.get_device_name(dev)}),
            flush=True)
        del case, d
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
