"""AEV glue and other device work: device ms a step of every kernel and
copy of the profiled chunks outside the asn and MLP groups
(counts/groups.json)."""

from portbench import trace


def read(ctx):
    if not ctx.steps:
        return None
    return trace.device_us_by_group(ctx.trace, ctx.groups)["glue"] \
        * 1e-3 / ctx.steps
