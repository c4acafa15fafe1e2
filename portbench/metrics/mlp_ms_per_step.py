"""MLP ensemble: device ms a step of the matrix products of the profiled
chunks (the 'mlp' name patterns of counts/groups.json)."""

from portbench import trace


def read(ctx):
    if not ctx.steps:
        return None
    return trace.device_us_by_group(ctx.trace, ctx.groups)["mlp"] \
        * 1e-3 / ctx.steps
