"""Integrator and thermo: device ms a step of the kernels and copies
launched inside the program's `integrate`, `thermo`, `skin_check` and
`deficit_check` spans in the recorded pass (portbench/spans.py)."""

from portbench import spans


def read(ctx):
    p = spans.of(ctx)
    if p is None:
        return None
    by = spans.device_ns_by_layer(p, ctx.groups)
    return spans.ms_per_step(p, sum(by["integrate"].values()))
