"""Kernels: device ms a step of the asn kernels of the profiled chunks
(every asn_*_kernel and dh_reduce_kernel, counts/groups.json)."""

from portbench import trace


def read(ctx):
    if not ctx.steps:
        return None
    return trace.device_us_by_group(ctx.trace, ctx.groups)["asn_kernels"] \
        * 1e-3 / ctx.steps
