"""Kernels: the asn kernels' share of their roofline, in %: the sum of
their bounds (counts/asn_kernels.json on the work counted from positions,
per step or per rebuild) over their measured device time in the profiled
chunks. Rebuilds are the trace's asn_build_inv_kernel launches."""

from portbench import trace
from portbench.counts import work as workmod


def read(ctx):
    measured_us = trace.device_us_by_group(ctx.trace, ctx.groups)[
        "asn_kernels"]
    if not ctx.steps or measured_us <= 0:
        return None
    rebuilds = sum(1 for e in ctx.trace.device
                   if "asn_build_inv_kernel" in e[0])
    bound = workmod.asn_bound_s(ctx.tables, ctx.work, ctx.steps, rebuilds)
    return 100.0 * sum(bound.values()) / (measured_us * 1e-6)
