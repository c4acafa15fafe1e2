"""MD host loop: device-to-host reads a step, counted by the program
(`profiling.to_host`, every site) over the recorded pass's steps
(portbench/spans.py)."""

from portbench import spans


def read(ctx):
    p = spans.of(ctx)
    return sum(p.syncs.values()) / p.steps if p is not None else None
