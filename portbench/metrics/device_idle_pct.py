"""Device: the idle share of the profiled chunks, in %: 1 - (the union of
kernel and copy intervals) / (the traced window's length on the host's
clock), both from the same trace of the device's activity alone."""

from portbench import trace


def read(ctx):
    if ctx.trace.window_us <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_us(ctx.trace) / ctx.trace.window_us)
