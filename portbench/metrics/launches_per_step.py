"""MD host loop: CUDA kernel launches a step (kernel events of the
profiled chunks over their steps; copies not counted)."""


def read(ctx):
    return len(ctx.trace.kernels()) / ctx.steps if ctx.steps else None
