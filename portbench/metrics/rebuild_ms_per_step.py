"""Rebuild: device ms a step of the kernels and copies launched inside
the program's `rebuild` spans (the wrap, `build_bins`,
`build_assignment`, the overflow reads) in the recorded pass
(portbench/spans.py)."""

from portbench import spans


def read(ctx):
    p = spans.of(ctx)
    if p is None:
        return None
    by = spans.device_ns_by_layer(p, ctx.groups)
    return spans.ms_per_step(p, sum(by["rebuild"].values()))
