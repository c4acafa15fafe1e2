"""Device: the step's counted work over the f32 peak, in %: counted FLOPs
(counts/work.py: the asn tables' fp32 instructions and the MLP's products
forward and for the input gradient) of the profiled steps over (the
traced window's length on the host's clock x 67 TFLOP/s)."""

from portbench.counts import work as workmod


def read(ctx):
    if not ctx.steps or ctx.trace.window_us <= 0:
        return None
    rebuilds = sum(1 for e in ctx.trace.device
                   if "asn_build_inv_kernel" in e[0])
    flops = workmod.step_flops(ctx.cfg, ctx.tables, ctx.work, ctx.steps,
                               rebuilds)
    return 100.0 * flops / (ctx.trace.window_us * 1e-6
                            * ctx.tables["peaks"]["f32_flops"])
